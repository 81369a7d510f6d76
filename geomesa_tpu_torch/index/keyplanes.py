"""Schema -> index-key encode plumbing for the resident cache.

Copy of ``geomesa_tpu/index/keyplanes.py``: one kind-dispatch table for
the four spatial key spaces -- z3/z2 Morton keys for point geometries
(with/without a date field), xz3/xz2 extent curves for non-point ones.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.curves.xz3 import XZ3SFC
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.features.sft import SimpleFeatureType


def schema_kind(sft: SimpleFeatureType):
    """(kind, sfc) the schema's key planes use: z3/z2 for point geometries
    (with/without a date field), xz3/xz2 for non-point ones, (None, None)
    when the SFT has no geometry. Honors the ``geomesa.z3.interval`` and
    ``geomesa.xz.precision`` user-data hints, as the durable key spaces
    do."""
    geom = sft.geom_field
    if geom is None:
        return None, None
    dtg = sft.dtg_field
    if not sft.descriptor(geom).is_point:
        if dtg is not None:
            return "xz3", XZ3SFC(TimePeriod.parse(sft.z3_interval), sft.xz_precision)
        return "xz2", XZ2SFC(sft.xz_precision)
    if dtg is not None:
        return "z3", Z3SFC(TimePeriod.parse(sft.z3_interval))
    return "z2", Z2SFC()


def encode_inputs(batch, kind: str, sfc, geom_field: str, dtg_field=None):
    """(coords, bins) host-side encode inputs for a batch: float64 coord
    arrays in the sfc's positional encode order (``sfc.index(*coords)``),
    plus the int64 period-bin plane (None for unbinned kinds). xz kinds
    take the geometry envelopes; xz3's order is [x0, y0, t, x1, y1, t]."""
    bins = None
    if kind in ("z3", "z2"):
        x, y = batch.point_coords(geom_field)
        coords = [np.asarray(x, np.float64), np.asarray(y, np.float64)]
        if kind == "z3":
            bins, off = to_binned_time(batch.column(dtg_field), sfc.period)
            coords.append(np.asarray(off, np.float64))
        return coords, bins
    bb = batch.bboxes(geom_field)
    if kind == "xz3":
        bins, off = to_binned_time(batch.column(dtg_field), sfc.period)
        offf = np.asarray(off, np.float64)
        coords = [bb[:, 0], bb[:, 1], offf, bb[:, 2], bb[:, 3], offf]
    else:
        coords = [bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]]
    return coords, bins
