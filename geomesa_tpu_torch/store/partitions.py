"""Named filesystem partition schemes.

Copy of ``geomesa_tpu/store/partitions.py`` (ref: geomesa-fs
storage/api/PartitionScheme and the stock schemes, Z2Scheme, XZ2Scheme,
DateTimeScheme, AttributeScheme and composites such as
``hourly,z2-2bit``). A scheme maps each feature to a directory-leaf string
and, at query time, decides whether an existing leaf can contain matching
features (the partition prune, a per-leaf ``matches`` test).

Scheme spec strings (SFT user data ``geomesa.fs.partition-scheme``):

- ``z2-<n>bit[s]``   -- point grid cells, n total z bits (n/2 per dim)
- ``xz2-<n>bit[s]``  -- non-point extent cells at XZ2 precision n
- ``xz3-<n>bit[s]``  -- non-point extent + week-bin time cells (XZ3)
- ``yearly | monthly | weekly | daily | hourly | minute`` -- dtg buckets
- ``attribute:<name>`` -- one leaf per attribute value
- comma-joined composites, e.g. ``daily,z2-2bit`` (leaf paths nest)

Where the counterpart formats one leaf string per row and groups the rows
by comparing strings, each scheme here computes an integer code per row
and formats one string per distinct code (``leaf_codes``), and
``leaf_groups`` hands the flush each leaf's rows in one stable sort: the
same leaves, in the same (string) order, with the same rows, at a cost
that does not grow with rows times leaves. ``leaves`` still returns the
per-row strings.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Envelope

USER_DATA_KEY = "geomesa.fs.partition-scheme"

# -- partition file naming ---------------------------------------------------
#
# Crash-consistent flushes write each rewrite as a fresh GENERATION of files
# next to the previous one (`part-<gen>-NNNNN.<enc>`), publish the manifest
# atomically, then collect the old generation; the un-scoped form
# (`part-NNNNN.<enc>`) names files of pre-generation manifests. The recovery
# sweep reclaims anything `part-`ish that the manifest does not reference.


def part_file_name(pid: int, encoding: str, gen: "str | None" = None) -> str:
    """Partition file name: generation-scoped when ``gen`` is set, the
    un-scoped form otherwise."""
    if gen:
        return f"part-{gen}-{pid:05d}.{encoding}"
    return f"part-{pid:05d}.{encoding}"


def _sorted_codes(inverse: np.ndarray, labels) -> "tuple[np.ndarray, list]":
    """Renumber per-row codes so that equal leaf strings share one code and
    codes follow the strings' sort order."""
    lab = np.empty(len(labels), dtype=object)
    lab[:] = list(labels)
    if not len(lab):
        return np.zeros(0, dtype=np.int64), []
    uniq, remap = np.unique(lab, return_inverse=True)
    return remap.astype(np.int64)[inverse], list(uniq)


class PartitionScheme:
    """Base: subclasses define spec, depth (leaf path segments),
    ``leaf_codes()`` and ``matches()``."""

    spec: str
    depth: int = 1

    def leaf_codes(self, batch) -> "tuple[np.ndarray, list]":
        """(per-row code, leaf string of each code), codes in leaf order."""
        raise NotImplementedError

    def leaves(self, batch) -> np.ndarray:
        codes, labels = self.leaf_codes(batch)
        lab = np.empty(len(labels), dtype=object)
        lab[:] = labels
        return lab[codes]

    def leaf_groups(self, batch) -> "list[tuple[str, np.ndarray]]":
        """[(leaf, ascending row indices)] in sorted leaf order: what the
        counterpart's flush gets from ``sorted(set(leaves))`` and
        ``np.nonzero(leaves == leaf)``."""
        codes, labels = self.leaf_codes(batch)
        # few leaves: 16-bit codes take numpy's radix sort
        order = np.argsort(codes.astype(np.uint16) if len(labels) <= 1 << 16 else codes,
                           kind="stable")
        bounds = np.concatenate([[0], np.cumsum(np.bincount(codes, minlength=len(labels)))])
        return [
            (labels[k], order[bounds[k]: bounds[k + 1]])
            for k in range(len(labels))
            if bounds[k + 1] > bounds[k]
        ]

    def matches(self, leaf: str, geom_bounds, time_bounds) -> bool:
        """May this leaf contain features satisfying the extracted bounds?
        Conservative: True when the scheme cannot tell."""
        raise NotImplementedError

    def validate(self, sft) -> None:
        """Fail fast at schema-bind time when the SFT cannot support the
        scheme (checked by create_schema, before any writes)."""


#: a 1-D integer key spanning fewer values than this is coded by a table
#: lookup (one pass) instead of a sort
_DENSE_SPAN = 1 << 24


def _codes_of(values: np.ndarray, fmt) -> "tuple[np.ndarray, list]":
    """Per-row codes of an integer key array ((n,) or (n, k) of small
    codes), one formatted label per distinct key."""
    if values.ndim > 1:
        # (n, k) keys: fold the columns into one mixed-radix integer key
        cols = [_dense_unique(values[:, j])[::-1] for j in range(values.shape[1])]
        key = np.zeros(len(values), dtype=np.int64)
        for uniq_j, inv_j in cols:
            key = key * len(uniq_j) + inv_j.reshape(-1)
        codes, keys = _dense_unique(key)
        radices = [len(u) for u, _ in cols]
        labels = []
        for k in keys:
            digits = []
            for r in reversed(radices):
                digits.append(int(k % r))
                k //= r
            labels.append(fmt([u[d] for (u, _), d in zip(cols, reversed(digits))]))
        return _sorted_codes(codes, labels)
    codes, uniq = _dense_unique(values)
    return _sorted_codes(codes, [fmt(u) for u in uniq])


def _dense_unique(values: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(per-row code, distinct values ascending) of a 1-D integer array."""
    if len(values) and values.dtype.kind in "iu":
        lo, hi = int(values.min()), int(values.max())
        if hi - lo < _DENSE_SPAN:
            rel = (values - lo).astype(np.int64)
            present = np.bincount(rel, minlength=hi - lo + 1) > 0
            table = np.cumsum(present) - 1
            return table[rel], (np.nonzero(present)[0] + lo).astype(values.dtype)
    uniq, inv = np.unique(values, return_inverse=True)
    return inv.reshape(-1), uniq


# -- datetime ----------------------------------------------------------------

_STEPS = {
    # step -> (numpy datetime64 unit, leaf path segments)
    "yearly": ("Y", 1),
    "monthly": ("M", 2),
    "daily": ("D", 3),
    "hourly": ("h", 4),
    "minute": ("m", 5),
}

_WEEK_MS = 7 * 86400 * 1000


@dataclass
class DateTimeScheme(PartitionScheme):
    """dtg-bucket leaves: ``2020/01/05`` (daily), ``2020/01/05/13``
    (hourly), ... Weekly uses epoch-week leaves ``W2609`` (the Z3 curve's
    week binning)."""

    step: str

    def __post_init__(self):
        if self.step != "weekly" and self.step not in _STEPS:
            raise ValueError(f"unknown datetime step {self.step!r}")
        self.spec = self.step
        self.depth = 1 if self.step == "weekly" else _STEPS[self.step][1]

    def validate(self, sft) -> None:
        if sft.dtg_field is None:
            raise ValueError(f"datetime partition scheme {self.step!r} needs a Date field")

    def _dtg_col(self, batch) -> np.ndarray:
        dtg = batch.sft.dtg_field
        if dtg is None:
            raise ValueError("datetime partition scheme needs a Date field")
        return np.asarray(batch.column(dtg), dtype=np.int64)

    def leaf_codes(self, batch):
        ms = self._dtg_col(batch)
        if self.step == "weekly":
            return _codes_of(ms // _WEEK_MS, lambda w: f"W{w}")
        unit = _STEPS[self.step][0]
        buckets = ms.astype("datetime64[ms]").astype(f"datetime64[{unit}]").astype(np.int64)

        def fmt(b):
            s = np.datetime_as_string(np.int64(b).astype(f"datetime64[{unit}]"))
            return str(s).replace("-", "/").replace("T", "/").replace(":", "/")

        return _codes_of(buckets, fmt)

    def _bucket_ms(self, leaf: str) -> "tuple[int, int]":
        if self.step == "weekly":
            w = int(leaf[1:])
            return w * _WEEK_MS, (w + 1) * _WEEK_MS
        unit = _STEPS[self.step][0]
        parts = leaf.split("/")
        iso = parts[0]
        if len(parts) > 1:
            iso += "-" + parts[1]
        if len(parts) > 2:
            iso += "-" + parts[2]
        if len(parts) > 3:
            iso += "T" + parts[3]
        if len(parts) > 4:
            iso += ":" + parts[4]
        start = np.datetime64(iso, unit)
        return (
            int(start.astype("datetime64[ms]").astype(np.int64)),
            int((start + 1).astype("datetime64[ms]").astype(np.int64)),
        )

    def matches(self, leaf: str, geom_bounds, time_bounds) -> bool:
        if time_bounds is None or time_bounds.unbounded:
            return True
        lo, hi = self._bucket_ms(leaf)  # [lo, hi)
        for t0, t1 in time_bounds.values:
            if t0 < hi and t1 >= lo:
                return True
        return False


# -- z2 grid -----------------------------------------------------------------


_POINT_ONLY = (
    "z2 partition scheme requires a Point geometry field; "
    "use an xz2 scheme for non-point geometries"
)


@dataclass
class Z2Scheme(PartitionScheme):
    """Point-grid leaves: the feature's z2 cell at ``bits`` total bits
    (``bits/2`` per dimension), zero-padded decimal."""

    bits: int

    def __post_init__(self):
        if self.bits % 2 or not (2 <= self.bits <= 32):
            raise ValueError("z2 scheme bits must be even, in [2, 32]")
        self.spec = f"z2-{self.bits}bits"
        self.res = self.bits // 2  # bits per dimension
        self.digits = len(str((1 << self.bits) - 1))

    def validate(self, sft) -> None:
        geom = sft.geom_field
        if geom is None or sft.descriptor(geom).type_name != "Point":
            raise ValueError(_POINT_ONLY)

    def _cells(self, x, y) -> np.ndarray:
        n = 1 << self.res
        ix = np.clip(((np.asarray(x) + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
        iy = np.clip(((np.asarray(y) + 90.0) / 180.0 * n).astype(np.int64), 0, n - 1)
        if self.res <= 12:
            # a Morton code ORs each dimension's spread bits: two table
            # lookups instead of the per-row bit interleave
            cells = np.arange(n, dtype=np.uint64)
            zero = np.zeros(n, dtype=np.uint64)
            return zorder.encode_2d_np(cells, zero)[ix] | zorder.encode_2d_np(zero, cells)[iy]
        return zorder.encode_2d_np(ix.astype(np.uint64), iy.astype(np.uint64))

    def leaf_codes(self, batch):
        col = batch.columns[batch.sft.geom_field]
        if col.dtype == object:
            # a polygon's extent can span many cells, but a feature lives
            # in exactly one leaf: single-cell pruning would drop results
            raise ValueError(_POINT_ONLY)
        return _codes_of(self._cells(col[:, 0], col[:, 1]), lambda z: f"{int(z):0{self.digits}d}")

    def _cell_env(self, leaf: str) -> Envelope:
        ix, iy = zorder.decode_2d_np(np.array([int(leaf)], dtype=np.uint64))
        n = 1 << self.res
        w, h = 360.0 / n, 180.0 / n
        xmin = -180.0 + float(ix[0]) * w
        ymin = -90.0 + float(iy[0]) * h
        return Envelope(xmin, ymin, xmin + w, ymin + h)

    def matches(self, leaf: str, geom_bounds, time_bounds) -> bool:
        if geom_bounds is None or geom_bounds.unbounded:
            return True
        cell = self._cell_env(leaf)
        return any(env.intersects(cell) for env, _ in geom_bounds.values)


def _geom_envelopes(batch):
    """Per-feature envelope bounds of the default geometry column (point
    fast path; shared by the extent-preserving xz schemes)."""
    col = batch.columns[batch.sft.geom_field]
    if col.dtype != object:
        return col[:, 0], col[:, 1], col[:, 0], col[:, 1]
    envs = [g.envelope for g in col]
    return (
        np.array([e.xmin for e in envs]),
        np.array([e.ymin for e in envs]),
        np.array([e.xmax for e in envs]),
        np.array([e.ymax for e in envs]),
    )


@dataclass
class XZ2Scheme(PartitionScheme):
    """Non-point extent leaves: the geometry envelope's XZ2 code at
    precision ``bits`` (extent-preserving; a leaf is pruned by the XZ2
    ranges of the query box at the same precision)."""

    bits: int

    def __post_init__(self):
        if not (1 <= self.bits <= 12):
            raise ValueError("xz2 scheme bits must be in [1, 12]")
        self.spec = f"xz2-{self.bits}bits"
        self.sfc = XZ2SFC(self.bits)
        max_code = np.atleast_1d(self.sfc.index(179.0, 89.0, 180.0, 90.0))[0]
        self.digits = len(str(int(max_code)))

    def leaf_codes(self, batch):
        codes = np.atleast_1d(self.sfc.index(*_geom_envelopes(batch))).astype(np.int64)
        return _codes_of(codes, lambda c: f"{int(c):0{self.digits}d}")

    def matches(self, leaf: str, geom_bounds, time_bounds) -> bool:
        if geom_bounds is None or geom_bounds.unbounded:
            return True
        code = int(leaf)
        for env, _ in geom_bounds.values:
            for r in self.sfc.ranges(env.xmin, env.ymin, env.xmax, env.ymax):
                if r.lower <= code <= r.upper:
                    return True
        return False


@dataclass
class XZ3Scheme(PartitionScheme):
    """Non-point spatio-temporal leaves: ``W<epoch-bin>/<xz3>`` -- the
    geometry envelope's XZ3 code at precision ``bits`` inside its time bin
    (extent-preserving like xz2, with the Z3 curve's week binning)."""

    bits: int
    period: str = "week"
    depth = 2

    def __post_init__(self):
        if not (1 <= self.bits <= 12):
            raise ValueError("xz3 scheme bits must be in [1, 12]")
        from geomesa_tpu_torch.curves.binnedtime import TimePeriod
        from geomesa_tpu_torch.curves.xz3 import XZ3SFC

        self.spec = f"xz3-{self.bits}bits"
        self.sfc = XZ3SFC(TimePeriod.parse(self.period), self.bits)
        # minimal-extent probe at the max corner: a full-extent window
        # stops octree subdivision early and under-reports the code width
        tm = self.sfc.t_max
        probe = np.atleast_1d(self.sfc.index(180.0, 90.0, tm, 180.0, 90.0, tm))[0]
        self.digits = len(str(int(probe)))

    def validate(self, sft) -> None:
        if sft.geom_field is None or sft.dtg_field is None:
            raise ValueError("xz3 partition scheme needs a geometry and a Date field")

    def leaf_codes(self, batch):
        from geomesa_tpu_torch.curves.binnedtime import to_binned_time

        xmin, ymin, xmax, ymax = _geom_envelopes(batch)
        ms = np.asarray(batch.column(batch.sft.dtg_field), dtype=np.int64)
        bins, off = to_binned_time(ms, self.period)
        off = np.asarray(off).astype(np.float64)
        codes = np.atleast_1d(self.sfc.index(xmin, ymin, off, xmax, ymax, off))
        keys = np.stack([np.atleast_1d(bins).astype(np.int64), codes.astype(np.int64)], axis=1)
        return _codes_of(keys, lambda bc: f"W{int(bc[0])}/{int(bc[1]):0{self.digits}d}")

    def matches(self, leaf: str, geom_bounds, time_bounds) -> bool:
        from geomesa_tpu_torch.curves.binnedtime import max_offset, to_binned_time

        bin_part, code_part = leaf.split("/")
        b = int(bin_part[1:])
        code = int(code_part)
        if time_bounds is not None and not time_bounds.unbounded:
            mx = max_offset(self.period)
            ok_t = False
            windows = []
            for t0, t1 in time_bounds.values:
                b0, o0 = to_binned_time(np.int64(t0), self.period)
                b1, o1 = to_binned_time(np.int64(t1), self.period)
                if not (int(b0) <= b <= int(b1)):
                    continue
                ok_t = True
                lo = float(o0) if b == int(b0) else 0.0
                hi = float(o1) if b == int(b1) else float(mx)
                windows.append((lo, hi))
            if not ok_t:
                return False
        else:
            windows = [(0.0, float(max_offset(self.period)))]
        if geom_bounds is None or geom_bounds.unbounded:
            return True
        for env, _ in geom_bounds.values:
            for lo, hi in windows:
                for r in self._ranges_cached(env.xmin, env.ymin, lo, env.xmax, env.ymax, hi):
                    if r.lower <= code <= r.upper:
                        return True
        return False

    def _ranges_cached(self, xmin, ymin, lo, xmax, ymax, hi):
        """matches() runs once per leaf but the octree decomposition only
        depends on the query window: memoize it per (env, window)."""
        if not hasattr(self, "_range_cache"):
            self._range_cache = {}
        key = (xmin, ymin, lo, xmax, ymax, hi)
        if key not in self._range_cache:
            if len(self._range_cache) > 256:
                self._range_cache.clear()
            self._range_cache[key] = self.sfc.ranges(xmin, ymin, lo, xmax, ymax, hi)
        return self._range_cache[key]


# -- attribute ---------------------------------------------------------------


def _equality_values(f, attr: str) -> "set | None":
    """Values ``attr`` may take under ``f``; None = unconstrained."""
    if isinstance(f, ast.Compare) and f.attr == attr and f.op == "=":
        return {f.value}
    if isinstance(f, ast.In) and f.attr == attr:
        return set(f.values)
    if isinstance(f, ast.And):
        out = None
        for c in f.children:
            v = _equality_values(c, attr)
            if v is not None:
                out = v if out is None else (out & v)
        return out
    if isinstance(f, ast.Or):
        out: set = set()
        for c in f.children:
            v = _equality_values(c, attr)
            if v is None:
                return None  # one branch unconstrained -> no prune
            out |= v
        return out
    return None


_UNSAFE_LEAF = re.compile(r"[^A-Za-z0-9_.\-]")


def _safe_leaf(v) -> str:
    """Attribute value -> filesystem-safe single path segment (no '/',
    no traversal, never empty)."""
    s = _UNSAFE_LEAF.sub("_", str(v)).lstrip(".")
    return s or "_"


@dataclass
class AttributeScheme(PartitionScheme):
    """One leaf per attribute value. Pruning uses equality / IN
    constraints extracted from the residual filter. Values are sanitized
    to a single safe path segment."""

    attr: str

    def __post_init__(self):
        self.spec = f"attribute:{self.attr}"

    def validate(self, sft) -> None:
        if self.attr not in sft.attribute_names:
            raise ValueError(f"attribute partition scheme: no attribute {self.attr!r}")

    def leaf_codes(self, batch):
        col = batch.column(self.attr)
        if col.dtype != object:
            inv, uniq = _dense_unique(col) if col.dtype.kind in "iu" else np.unique(
                col, return_inverse=True)[::-1]
            return _sorted_codes(inv.reshape(-1), [_safe_leaf(v) for v in uniq])
        seen: dict = {}
        codes = np.fromiter(
            (seen.setdefault(_safe_leaf(v), len(seen)) for v in col), dtype=np.int64, count=len(col))
        return _sorted_codes(codes, list(seen))

    def matches(self, leaf: str, geom_bounds, time_bounds, filter=None) -> bool:
        if filter is None:
            return True
        vals = _equality_values(filter, self.attr)
        return vals is None or leaf in {_safe_leaf(v) for v in vals}


# -- composite ---------------------------------------------------------------


class CompositeScheme(PartitionScheme):
    """Nested leaves, outer scheme first: ``daily,z2-2bit`` gives
    ``2020/01/05/03`` paths."""

    def __init__(self, parts: "list[PartitionScheme]"):
        self.parts = parts
        # ':' join so the spec survives the comma-delimited SFT spec string
        # (scheme_for accepts either separator)
        self.spec = ":".join(p.spec for p in parts)
        self.depth = sum(p.depth for p in parts)

    def validate(self, sft) -> None:
        for p in self.parts:
            p.validate(sft)

    def leaf_codes(self, batch):
        per_part = [p.leaf_codes(batch) for p in self.parts]
        if not len(batch):
            return np.zeros(0, dtype=np.int64), []
        keys = np.stack([c for c, _ in per_part], axis=1)
        return _codes_of(keys, lambda row: "/".join(
            labels[int(k)] for k, (_, labels) in zip(row, per_part)))

    def matches(self, leaf: str, geom_bounds, time_bounds, filter=None) -> bool:
        segs = leaf.split("/")
        off = 0
        for p in self.parts:
            sub = "/".join(segs[off: off + p.depth])
            off += p.depth
            if isinstance(p, AttributeScheme):
                ok = p.matches(sub, geom_bounds, time_bounds, filter=filter)
            else:
                ok = p.matches(sub, geom_bounds, time_bounds)
            if not ok:
                return False
        return True


# -- parsing -----------------------------------------------------------------

_ZBITS = re.compile(r"^(x?z[23])-(\d+)bits?$")


def scheme_for(spec: str) -> PartitionScheme:
    """Parse a scheme spec string (see module docstring). Composites may
    be ','- or ':'-joined; the ':' form is what persists through the SFT
    spec round-trip."""
    # 'attribute:name' contains ':' legitimately -- protect it, then split
    protected = re.sub(r"\b(attr|attribute):", r"\1=", spec)
    parts = [s.strip().replace("=", ":", 1) for s in re.split(r"[,:]", protected) if s.strip()]
    if not parts:
        raise ValueError("empty partition scheme spec")
    schemes = []
    for part in parts:
        m = _ZBITS.match(part)
        if m:
            kind = m.group(1)
            if kind == "z2":
                schemes.append(Z2Scheme(int(m.group(2))))
            elif kind == "xz2":
                schemes.append(XZ2Scheme(int(m.group(2))))
            elif kind == "xz3":
                schemes.append(XZ3Scheme(int(m.group(2))))
            else:
                raise ValueError(f"unknown partition scheme {part!r}")
        elif part in _STEPS or part == "weekly":
            schemes.append(DateTimeScheme(part))
        elif part.startswith(("attribute:", "attr:")):
            schemes.append(AttributeScheme(part.split(":", 1)[1]))
        elif part == "datetime":
            schemes.append(DateTimeScheme("daily"))
        else:
            raise ValueError(f"unknown partition scheme {part!r}")
    return schemes[0] if len(schemes) == 1 else CompositeScheme(schemes)


def scheme_matches(scheme, leaf, plan) -> bool:
    """Prune test against a QueryPlan's extracted bounds."""
    if isinstance(scheme, (AttributeScheme, CompositeScheme)):
        return scheme.matches(leaf, plan.geom_bounds, plan.time_bounds, filter=plan.filter)
    return scheme.matches(leaf, plan.geom_bounds, plan.time_bounds)
