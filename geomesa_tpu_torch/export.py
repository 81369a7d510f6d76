"""Feature export formats.

Counterpart of ``geomesa_tpu/export.py``, trimmed to
:func:`feature_collection`, the GeoJSON body of the server's ``/features``,
``/knn``, ``/tube`` and ``/proximity``. ``write_batch`` and the binary
writers wait for the CLI's ``export``.
"""

from __future__ import annotations


def feature_collection(batch) -> dict:
    """FeatureBatch -> GeoJSON FeatureCollection dict (all geometry types
    encoded as real GeoJSON geometries via geom/geojson.py)."""
    import numpy as np

    from geomesa_tpu_torch.geom.geojson import to_geojson

    geom = batch.sft.geom_field
    features = []
    for i in range(len(batch)):
        props = {}
        geometry = None
        for name in batch.sft.attribute_names:
            c = batch.columns[name]
            desc = batch.sft.descriptor(name)
            if name == geom:
                if c.dtype != object:
                    geometry = {
                        "type": "Point",
                        "coordinates": [float(c[i, 0]), float(c[i, 1])],
                    }
                else:
                    geometry = to_geojson(c[i])
            elif desc.type_name == "Date":
                props[name] = str(np.datetime64(int(c[i]), "ms"))
            else:
                v = c[i]
                v = v.item() if hasattr(v, "item") else v
                if isinstance(v, float) and not np.isfinite(v):
                    v = None  # bare NaN/Infinity is invalid strict JSON
                props[name] = v
        features.append(
            {
                "type": "Feature",
                "id": str(batch.fids[i]),
                "geometry": geometry,
                "properties": props,
            }
        )
    return {"type": "FeatureCollection", "features": features}
