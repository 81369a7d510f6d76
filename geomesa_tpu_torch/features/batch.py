"""FeatureBatch: the columnar SimpleFeature collection.

Copy of ``geomesa_tpu/features/batch.py``, trimmed to what the port uses:
``from_columns``, ``concat``, ``column``, ``point_coords``, ``bboxes``,
``take``, ``__len__`` and the reserved visibility column, with
:func:`fids_in` (the stores' delete-by-id membership). The counterpart's
``to_arrow``/``from_arrow`` have theirs in ``store/partfile.py``, the
file-system store's codec. Column conventions are
the counterpart's:

- Point geometry  -> (n, 2) float64 array [x, y]
- other geometry  -> object array of ``geom`` Geometry values, with a
                     cached (n, 4) float64 envelope array [xmin, ymin,
                     xmax, ymax] per column (``bboxes``)
- Date            -> int64 epoch milliseconds
- numeric/bool    -> matching numpy dtype
- String/UUID/Bytes -> object array (host-only)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Geometry, Point, parse_wkt

VIS_COLUMN = "__vis__"  # reserved per-feature visibility label column


@dataclass
class FeatureBatch:
    sft: SimpleFeatureType
    fids: np.ndarray
    columns: dict
    _bboxes: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def from_columns(sft: SimpleFeatureType, columns: dict, fids=None) -> "FeatureBatch":
        """Build from {attribute: values}. Geometry columns may be given as
        (n, 2) point arrays, Geometry objects or WKT strings; dates as int64
        millis or numpy datetime64."""
        n = None
        out: dict = {}
        for attr in sft.attributes:
            if attr.name not in columns:
                raise ValueError(f"missing column {attr.name!r}")
            vals = columns[attr.name]
            if attr.is_geometry:
                col = _coerce_geometry(vals, attr.is_point)
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

    @staticmethod
    def concat(batches: "list[FeatureBatch]") -> "FeatureBatch":
        """Rows of ``batches`` in order, one batch. Unlabeled batches
        mixed with labeled ones contribute public rows (label "")."""
        if not batches:
            raise ValueError("no batches")
        names = set()
        for b in batches:
            names.update(b.columns)
        cols = {}
        for name in names:
            parts = []
            for b in batches:
                if name in b.columns:
                    parts.append(b.columns[name])
                elif name == VIS_COLUMN:
                    parts.append(np.array([""] * len(b), dtype=object))
                else:
                    raise KeyError(f"column {name!r} missing from a concatenated batch")
            cols[name] = np.concatenate(parts)
        return FeatureBatch(batches[0].sft, np.concatenate([b.fids for b in batches]), cols)

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

    def with_visibility(self, vis) -> "FeatureBatch":
        """Attach per-feature visibility labels (the reserved
        ``VIS_COLUMN``)."""
        vis = np.asarray(vis, dtype=object)
        if len(vis) != len(self):
            raise ValueError("visibility length mismatch")
        cols = dict(self.columns)
        cols[VIS_COLUMN] = vis
        return FeatureBatch(self.sft, self.fids, cols)

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

    def bboxes(self, name: str | None = None) -> np.ndarray:
        """(n, 4) float64 [xmin, ymin, xmax, ymax] for any geometry column
        (cached per non-point column)."""
        name = name or self.sft.geom_field
        col = self.columns[name]
        if col.dtype != object:
            return np.stack([col[:, 0], col[:, 1], col[:, 0], col[:, 1]], axis=1)
        if name not in self._bboxes:
            bb = np.empty((len(col), 4), dtype=np.float64)
            for i, g in enumerate(col):
                e = g.envelope
                bb[i] = (e.xmin, e.ymin, e.xmax, e.ymax)
            self._bboxes[name] = bb
        return self._bboxes[name]


def _coerce_geometry(vals, is_point: bool) -> np.ndarray:
    if isinstance(vals, np.ndarray) and vals.dtype != object and vals.ndim == 2:
        return np.asarray(vals, dtype=np.float64)
    vals = list(vals)
    if not vals:
        return (
            np.zeros((0, 2), dtype=np.float64)
            if is_point
            else np.array([], dtype=object)
        )
    if is_point:
        try:  # fast path: homogeneous (x, y) pairs
            arr = np.asarray(vals, dtype=np.float64)
            if arr.ndim == 2 and arr.shape[1] == 2:
                return arr
        except (ValueError, TypeError):
            pass

        # per-row coercion: a column may mix WKT strings, Point objects
        # and coordinate pairs
        def xy(v):
            if isinstance(v, str):
                v = parse_wkt(v)
            if isinstance(v, Point):
                return (v.x, v.y)
            if isinstance(v, (tuple, list, np.ndarray)):
                return tuple(np.asarray(v, dtype=np.float64))
            raise TypeError(f"cannot coerce {type(v)} to Point column")

        return np.asarray([xy(v) for v in vals], dtype=np.float64)
    out = [parse_wkt(v) if isinstance(v, str) else v for v in vals]
    if isinstance(out[0], Geometry):
        col = np.empty(len(out), dtype=object)
        col[:] = out
        return col
    raise TypeError(f"cannot coerce {type(out[0])} to geometry column")


def _coerce_date(vals) -> np.ndarray:
    a = np.asarray(vals)
    if np.issubdtype(a.dtype, np.datetime64):
        return a.astype("datetime64[ms]").astype(np.int64)
    if a.dtype == object or a.dtype.kind in "US":
        return np.array(a, dtype="datetime64[ms]").astype(np.int64)
    return a.astype(np.int64)


def fids_in(col: np.ndarray, fids) -> np.ndarray:
    """Which of the fid column ``col`` are among ``fids``, by ``==`` as the
    counterpart's ``np.isin(col, np.asarray(list(fids), dtype=object))``
    compares (a mixed int/str id list does not collapse to str), in linear
    time: numpy's object-array membership compares every pair, and an
    age-off of 2^16 rows took minutes that way (ROADMAP section 3). An
    integer column takes numpy's integer membership with the integral
    ids (a str never equals an int); any other column a set lookup a row."""
    ids = list(fids)
    if col.dtype.kind in "iu":
        ints = [int(f) for f in ids if isinstance(f, (int, np.integer))
                or (isinstance(f, (float, np.floating)) and float(f).is_integer())]
        return np.isin(col, np.asarray(ints, dtype=np.int64))
    want = set(ids)
    return np.fromiter((f in want for f in col.tolist()), dtype=bool, count=len(col))
