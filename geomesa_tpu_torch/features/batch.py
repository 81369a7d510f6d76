"""FeatureBatch: the columnar SimpleFeature collection.

Copy of ``geomesa_tpu/features/batch.py``, trimmed to what the slice uses:
``from_columns``, ``column``, ``point_coords``, ``take``, ``__len__`` and
the reserved visibility column (carried so the resident index can refuse
labeled rows). Column conventions are the counterpart's:

- Point geometry  -> (n, 2) float64 array [x, y]
- Date            -> int64 epoch milliseconds
- numeric/bool    -> matching numpy dtype
- String/UUID/Bytes -> object array (host-only)

Non-point geometry columns belong to the xz slice and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Point, parse_wkt

VIS_COLUMN = "__vis__"  # reserved per-feature visibility label column


@dataclass
class FeatureBatch:
    sft: SimpleFeatureType
    fids: np.ndarray
    columns: dict

    @staticmethod
    def from_columns(sft: SimpleFeatureType, columns: dict, fids=None) -> "FeatureBatch":
        """Build from {attribute: values}. Point columns may be given as
        (n, 2) arrays, Point objects or WKT strings; dates as int64 millis
        or numpy datetime64."""
        n = None
        out: dict = {}
        for attr in sft.attributes:
            if attr.name not in columns:
                raise ValueError(f"missing column {attr.name!r}")
            vals = columns[attr.name]
            if attr.is_geometry:
                if not attr.is_point:
                    raise NotImplementedError(
                        f"{attr.type_name} column {attr.name!r}: non-point "
                        "geometries (xz3/xz2 keys) are a later port slice "
                        "(ROADMAP, port queue: interleaved-layout and xz scans)"
                    )
                col = _coerce_points(vals)
            elif attr.type_name == "Date":
                col = _coerce_date(vals)
            elif attr.column_dtype is not None:
                col = np.asarray(vals).astype(attr.column_dtype)
            else:
                col = np.asarray(vals, dtype=object)
            m = len(col)
            if n is None:
                n = m
            elif m != n:
                raise ValueError(
                    f"column {attr.name!r} has {m} rows, expected {n}"
                )
            out[attr.name] = col
        if n is None:
            n = 0
        if VIS_COLUMN in columns:
            vis = np.asarray(columns[VIS_COLUMN], dtype=object)
            if len(vis) != n:
                raise ValueError("visibility length mismatch")
            out[VIS_COLUMN] = vis
        if fids is None:
            fids = np.arange(n)
        fids = np.asarray(fids)
        if len(fids) != n:
            raise ValueError("fids length mismatch")
        return FeatureBatch(sft, fids, out)

    def __len__(self) -> int:
        return len(self.fids)

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def take(self, indices) -> "FeatureBatch":
        """Row gather -> new batch (copies)."""
        idx = np.asarray(indices)
        return FeatureBatch(
            self.sft,
            self.fids[idx],
            {k: v[idx] for k, v in self.columns.items()},
        )

    @property
    def visibilities(self) -> "np.ndarray | None":
        return self.columns.get(VIS_COLUMN)

    def point_coords(self, name: str | None = None):
        """(x, y) float64 arrays for a Point column (default geometry)."""
        name = name or self.sft.geom_field
        col = self.columns[name]
        if col.dtype == object:
            raise TypeError(f"{name!r} is not a Point column")
        return np.ascontiguousarray(col[:, 0]), np.ascontiguousarray(col[:, 1])


def _coerce_points(vals) -> np.ndarray:
    if isinstance(vals, np.ndarray) and vals.dtype != object and vals.ndim == 2:
        return np.asarray(vals, dtype=np.float64)
    vals = list(vals)
    if not vals:
        return np.zeros((0, 2), dtype=np.float64)

    def xy(v):
        if isinstance(v, str):
            v = parse_wkt(v)
        if isinstance(v, Point):
            return (v.x, v.y)
        if isinstance(v, (tuple, list, np.ndarray)):
            return tuple(np.asarray(v, dtype=np.float64))
        raise TypeError(f"cannot coerce {type(v)} to Point column")

    return np.asarray([xy(v) for v in vals], dtype=np.float64)


def _coerce_date(vals) -> np.ndarray:
    a = np.asarray(vals)
    if np.issubdtype(a.dtype, np.datetime64):
        return a.astype("datetime64[ms]").astype(np.int64)
    if a.dtype == object or a.dtype.kind in "US":
        return np.array(a, dtype="datetime64[ms]").astype(np.int64)
    return a.astype(np.int64)
