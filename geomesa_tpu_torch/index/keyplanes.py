"""Schema -> index-key encode plumbing for the resident cache.

Copy of ``geomesa_tpu/index/keyplanes.py`` for the point kinds (z3 with a
date field, z2 without). The extent-curve kinds (xz3/xz2, non-point
geometries) belong to a later slice and raise.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.features.sft import SimpleFeatureType

_XZ_LATER = (
    "xz3/xz2 extent-curve keys (non-point geometries) are a later port "
    "slice (ROADMAP, port queue: interleaved-layout and xz scans)"
)


def schema_kind(sft: SimpleFeatureType):
    """(kind, sfc) the schema's key planes use: z3/z2 for point geometries
    (with/without a date field), (None, None) when the SFT has no geometry.
    Honors the ``geomesa.z3.interval`` user-data hint, as the durable key
    spaces do."""
    geom = sft.geom_field
    if geom is None:
        return None, None
    if not sft.descriptor(geom).is_point:
        raise NotImplementedError(_XZ_LATER)
    if sft.dtg_field is not None:
        return "z3", Z3SFC(TimePeriod.parse(sft.z3_interval))
    return "z2", Z2SFC()


def encode_inputs(batch, kind: str, sfc, geom_field: str, dtg_field=None):
    """(coords, bins) host-side encode inputs for a batch: float64 coord
    arrays (x, y[, time offset]) plus the int64 period-bin plane (None for
    z2)."""
    if kind not in ("z3", "z2"):
        raise NotImplementedError(_XZ_LATER)
    bins = None
    x, y = batch.point_coords(geom_field)
    coords = [np.asarray(x, np.float64), np.asarray(y, np.float64)]
    if kind == "z3":
        bins, off = to_binned_time(batch.column(dtg_field), sfc.period)
        coords.append(np.asarray(off, np.float64))
    return coords, bins
