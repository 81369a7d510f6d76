"""GeoJSON geometry codec.

Copy of ``geomesa_tpu/geom/geojson.py`` (ref: the GeoTools GeoJSON
writers used by export): :func:`to_geojson` encodes a geometry as a
GeoJSON geometry dict, :func:`from_geojson` decodes one.
"""

from __future__ import annotations

import json

import numpy as np

from geomesa_tpu_torch.geom.base import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)


def _coords(a: np.ndarray) -> list:
    return [[float(x), float(y)] for x, y in np.asarray(a)]


def to_geojson(g: Geometry) -> dict:
    """Geometry -> GeoJSON geometry dict."""
    if isinstance(g, Point):
        return {"type": "Point", "coordinates": [float(g.x), float(g.y)]}
    if isinstance(g, LineString):
        return {"type": "LineString", "coordinates": _coords(g.coords)}
    if isinstance(g, Polygon):
        return {
            "type": "Polygon",
            "coordinates": [_coords(g.shell)] + [_coords(h) for h in g.holes],
        }
    if isinstance(g, MultiPoint):
        return {
            "type": "MultiPoint",
            "coordinates": [[float(p.x), float(p.y)] for p in g.points],
        }
    if isinstance(g, MultiLineString):
        return {
            "type": "MultiLineString",
            "coordinates": [_coords(l.coords) for l in g.lines],
        }
    if isinstance(g, MultiPolygon):
        return {
            "type": "MultiPolygon",
            "coordinates": [
                [_coords(p.shell)] + [_coords(h) for h in p.holes]
                for p in g.polygons
            ],
        }
    raise ValueError(f"cannot encode {type(g).__name__} as GeoJSON")


def from_geojson(doc) -> Geometry:
    """GeoJSON geometry (dict or JSON string) -> Geometry."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    t = doc.get("type")
    c = doc.get("coordinates")
    if t == "Point":
        return Point(float(c[0]), float(c[1]))
    if t == "LineString":
        return LineString(np.asarray(c, dtype=np.float64))
    if t == "Polygon":
        rings = [np.asarray(r, dtype=np.float64) for r in c]
        return Polygon(rings[0], tuple(rings[1:]))
    if t == "MultiPoint":
        return MultiPoint(tuple(Point(float(p[0]), float(p[1])) for p in c))
    if t == "MultiLineString":
        return MultiLineString(
            tuple(LineString(np.asarray(p, dtype=np.float64)) for p in c)
        )
    if t == "MultiPolygon":
        parts = []
        for rings in c:
            rs = [np.asarray(r, dtype=np.float64) for r in rings]
            parts.append(Polygon(rs[0], tuple(rs[1:])))
        return MultiPolygon(tuple(parts))
    raise ValueError(f"cannot decode GeoJSON type {t!r}")
