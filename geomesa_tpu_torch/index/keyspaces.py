"""Concrete index key spaces: Z3, Z2, XZ3, XZ2, attribute, id.

Copy of ``geomesa_tpu/index/keyspaces.py`` (ref: geomesa-index-api
Z3IndexKeySpace and its siblings); the point key spaces encode their row
ranges on the host build's workers (``index/build.py``). Key layouts follow the reference's
row-key structure minus the shard byte:

- z3:  (bin: int32, z: uint64)    bin = BinnedTime period index
- z2:  (z: uint64,)
- xz3: (bin: int32, xz: int64)
- xz2: (xz: int64,)
- attr: (value,) host-comparable
- id:  (fid,)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import (
    TimePeriod,
    bins_for_interval,
    max_offset,
    to_binned_time,
)
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.curves.xz3 import XZ3SFC
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.curves.zranges import DEFAULT_MAX_RANGES
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.extract import NEG_INF, POS_INF, FilterBounds
from geomesa_tpu_torch.index.api import KeyRange
from geomesa_tpu_torch.index.build import concat_ranges


def _envelopes(geoms: FilterBounds):
    return [v[0] for v in geoms.values]


def _open(t_lo: int, t_hi: int) -> bool:
    """An interval with an end at NEG_INF/POS_INF (BEFORE, AFTER, < or >
    on the date): its bins cannot be enumerated. The Z3 key space clips it
    to the data's interval first; the counterpart's XZ3 key space does not
    (and neither clips when the type holds no data), so it walks bins from
    -2^62 ms. The port clips the open ends of an XZ3 interval to the
    data's as Z3 does, and scans the full table where no data interval
    bounds it (ROADMAP section 3)."""
    return t_lo <= NEG_INF or t_hi >= POS_INF


@dataclass(frozen=True)
class Z3KeySpace:
    """Point geometries + time: (epoch bin, z3)."""

    geom_field: str
    dtg_field: str
    period: TimePeriod = TimePeriod.WEEK
    name: str = "z3"

    @property
    def key_columns(self) -> tuple:
        return ("bin", "z")

    @property
    def sfc(self) -> Z3SFC:
        return Z3SFC(self.period)

    def index_keys(self, batch: FeatureBatch) -> dict:
        x, y = batch.point_coords(self.geom_field)
        ms = batch.column(self.dtg_field)
        sfc = self.sfc

        def keys(a: int, b: int) -> dict:  # one row range (elementwise)
            bins, off = to_binned_time(ms[a:b], self.period)
            return {"bin": bins.astype(np.int32), "z": sfc.index(x[a:b], y[a:b], off)}

        return concat_ranges(keys, len(ms))

    def supports(self, geoms: FilterBounds, intervals: FilterBounds) -> bool:
        return not intervals.unbounded

    def cost(self, geoms: FilterBounds, intervals: FilterBounds) -> float:
        if intervals.unbounded:
            return float("inf")
        return 1.0 if not geoms.unbounded else 10.0

    def scan_ranges(
        self,
        geoms: FilterBounds,
        intervals: FilterBounds,
        max_ranges: int = DEFAULT_MAX_RANGES,
        data_interval=None,
    ):
        if intervals.unbounded:
            if data_interval is None:
                return None
            t_lo, t_hi = data_interval
        else:
            if intervals.empty or geoms.empty:
                return []
            t_lo = min(v[0] for v in intervals.values)
            t_hi = max(v[1] for v in intervals.values)
            if data_interval is not None:
                t_lo = max(t_lo, data_interval[0])
                t_hi = min(t_hi, data_interval[1])
            if t_lo > t_hi:
                return []
            if _open(t_lo, t_hi):
                return None
        envs = _envelopes(geoms) if not geoms.unbounded else [None]
        sfc = self.sfc
        mx = max_offset(self.period)
        spans = bins_for_interval(int(t_lo), int(t_hi), self.period)
        if len(spans) > max_ranges:
            # bin count alone exceeds the range budget: one coarse
            # lexicographic range over the whole (bin, z) span
            return [
                KeyRange((spans[0][0], 0), (spans[-1][0], (1 << 63) - 1), False)
            ]
        ranges: list[KeyRange] = []
        # middle whole-period bins share one decomposition (ref
        # Z3IndexKeySpace "whole period" optimization); per-bin budget keeps
        # the total under max_ranges (the geomesa.scan.ranges.target analog)
        whole_cache = None
        per_bin_budget = max(1, max_ranges // len(spans))
        for b, off_lo, off_hi in spans:
            whole = off_lo == 0 and off_hi == mx
            if whole and whole_cache is not None:
                zrs = whole_cache
            else:
                zrs = []
                for env in envs:
                    if env is None:
                        xmin, ymin, xmax, ymax = -180.0, -90.0, 180.0, 90.0
                    else:
                        xmin, ymin, xmax, ymax = env.xmin, env.ymin, env.xmax, env.ymax
                    zrs.extend(
                        sfc.ranges(
                            xmin, ymin, xmax, ymax,
                            float(off_lo), float(off_hi),
                            max_ranges=per_bin_budget,
                        )
                    )
                zrs.sort(key=lambda r: r.lower)
                if whole:
                    whole_cache = zrs
            for r in zrs:
                ranges.append(KeyRange((b, r.lower), (b, r.upper), r.contained))
        return ranges


@dataclass(frozen=True)
class Z2KeySpace:
    """Point geometries, no time: (z2,)."""

    geom_field: str
    name: str = "z2"

    @property
    def key_columns(self) -> tuple:
        return ("z",)

    @property
    def sfc(self) -> Z2SFC:
        return Z2SFC()

    def index_keys(self, batch: FeatureBatch) -> dict:
        x, y = batch.point_coords(self.geom_field)
        sfc = self.sfc
        return {"z": concat_ranges(lambda a, b: sfc.index(x[a:b], y[a:b]), len(x))}

    def supports(self, geoms: FilterBounds, intervals: FilterBounds) -> bool:
        return not geoms.unbounded

    def cost(self, geoms: FilterBounds, intervals: FilterBounds) -> float:
        return 2.0 if not geoms.unbounded else float("inf")

    def scan_ranges(
        self, geoms, intervals, max_ranges: int = DEFAULT_MAX_RANGES, data_interval=None
    ):
        if geoms.unbounded:
            return None
        if geoms.empty:
            return []
        ranges: list[KeyRange] = []
        budget = max(16, max_ranges // max(1, len(geoms.values)))
        for env, _ in geoms.values:
            for r in self.sfc.ranges(
                env.xmin, env.ymin, env.xmax, env.ymax, max_ranges=budget
            ):
                ranges.append(KeyRange((r.lower,), (r.upper,), r.contained))
        ranges.sort(key=lambda r: r.lo)
        return ranges


@dataclass(frozen=True)
class XZ2KeySpace:
    """Non-point geometries: (xz2,)."""

    geom_field: str
    g: int = 12
    name: str = "xz2"

    @property
    def key_columns(self) -> tuple:
        return ("xz",)

    @property
    def sfc(self) -> XZ2SFC:
        return XZ2SFC(self.g)

    def index_keys(self, batch: FeatureBatch) -> dict:
        bb = batch.bboxes(self.geom_field)
        return {
            "xz": self.sfc.index(bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3])
        }

    def supports(self, geoms, intervals) -> bool:
        return not geoms.unbounded

    def cost(self, geoms, intervals) -> float:
        return 3.0 if not geoms.unbounded else float("inf")

    def scan_ranges(self, geoms, intervals, max_ranges: int = DEFAULT_MAX_RANGES, data_interval=None):
        if geoms.unbounded:
            return None
        if geoms.empty:
            return []
        envs = _envelopes(geoms)
        rs = self.sfc.ranges(
            np.array([e.xmin for e in envs]),
            np.array([e.ymin for e in envs]),
            np.array([e.xmax for e in envs]),
            np.array([e.ymax for e in envs]),
            max_ranges=max_ranges,
        )
        return [KeyRange((r.lower,), (r.upper,), False) for r in rs]


@dataclass(frozen=True)
class XZ3KeySpace:
    """Non-point geometries + time: (bin, xz3)."""

    geom_field: str
    dtg_field: str
    period: TimePeriod = TimePeriod.WEEK
    g: int = 12
    name: str = "xz3"

    @property
    def key_columns(self) -> tuple:
        return ("bin", "xz")

    @property
    def sfc(self) -> XZ3SFC:
        return XZ3SFC(self.period, self.g)

    def index_keys(self, batch: FeatureBatch) -> dict:
        bb = batch.bboxes(self.geom_field)
        ms = batch.column(self.dtg_field)
        b, off = to_binned_time(ms, self.period)
        # instantaneous features: tmin == tmax == offset
        xz = self.sfc.index(bb[:, 0], bb[:, 1], off, bb[:, 2], bb[:, 3], off)
        return {"bin": b.astype(np.int32), "xz": xz}

    def supports(self, geoms, intervals) -> bool:
        return not intervals.unbounded

    def cost(self, geoms, intervals) -> float:
        if intervals.unbounded:
            return float("inf")
        return 1.5 if not geoms.unbounded else 10.0

    def scan_ranges(self, geoms, intervals, max_ranges: int = DEFAULT_MAX_RANGES, data_interval=None):
        if intervals.unbounded:
            if data_interval is None:
                return None
            t_lo, t_hi = data_interval
        else:
            if intervals.empty or geoms.empty:
                return []
            t_lo = min(v[0] for v in intervals.values)
            t_hi = max(v[1] for v in intervals.values)
            if data_interval is not None and _open(t_lo, t_hi):
                t_lo = max(t_lo, data_interval[0])
                t_hi = min(t_hi, data_interval[1])
                if t_lo > t_hi:
                    return []
            if _open(t_lo, t_hi):
                return None
        envs = _envelopes(geoms) if not geoms.unbounded else None
        spans = bins_for_interval(int(t_lo), int(t_hi), self.period)
        mx = max_offset(self.period)
        ranges: list[KeyRange] = []
        per_bin = max(16, max_ranges // max(1, len(spans)))
        for b, off_lo, off_hi in spans:
            if envs is None:
                xs = [(-180.0, -90.0, 180.0, 90.0)]
            else:
                xs = [(e.xmin, e.ymin, e.xmax, e.ymax) for e in envs]
            rs = self.sfc.ranges(
                np.array([e[0] for e in xs]),
                np.array([e[1] for e in xs]),
                np.full(len(xs), float(off_lo)),
                np.array([e[2] for e in xs]),
                np.array([e[3] for e in xs]),
                np.full(len(xs), float(off_hi)),
                max_ranges=per_bin,
            )
            for r in rs:
                ranges.append(KeyRange((b, r.lower), (b, r.upper), False))
        return ranges


@dataclass(frozen=True)
class AttributeKeySpace:
    """Secondary index on one attribute, sorted by value.
    (ref: geomesa-index-api .../index/attribute/AttributeIndexKeySpace)"""

    attr: str
    name: str = "attr"

    @property
    def key_columns(self) -> tuple:
        return ("value",)

    def index_keys(self, batch: FeatureBatch) -> dict:
        return {"value": batch.column(self.attr)}

    def supports(self, geoms, intervals) -> bool:
        # planner routes attribute predicates explicitly (see planner)
        return False

    def cost(self, geoms, intervals) -> float:
        return float("inf")

    def scan_ranges(self, geoms, intervals, max_ranges: int = DEFAULT_MAX_RANGES, data_interval=None):
        return None

    def ranges_for_values(self, bounds: FilterBounds):
        """Value bounds (from extract_intervals-style extraction or equality
        sets) -> ranges."""
        if bounds.unbounded:
            return None
        return [KeyRange((lo,), (hi,), False) for lo, hi in bounds.values]


@dataclass(frozen=True)
class IdKeySpace:
    """Primary key index on feature id."""

    name: str = "id"

    @property
    def key_columns(self) -> tuple:
        return ("fid",)

    def index_keys(self, batch: FeatureBatch) -> dict:
        return {"fid": batch.fids}

    def supports(self, geoms, intervals) -> bool:
        return False

    def cost(self, geoms, intervals) -> float:
        return float("inf")

    def scan_ranges(self, geoms, intervals, max_ranges: int = DEFAULT_MAX_RANGES, data_interval=None):
        return None


def keyspace_for(sft: SimpleFeatureType, name: str):
    """Index name -> key space, wired from SFT fields + user data.
    (ref: GeoMesaFeatureIndexFactory default index selection)"""
    geom = sft.geom_field
    dtg = sft.dtg_field
    period = TimePeriod.parse(sft.z3_interval)
    point = geom is not None and sft.descriptor(geom).is_point
    if name == "z3":
        if not (point and dtg):
            raise ValueError("z3 requires a Point default geometry and a Date field")
        return Z3KeySpace(geom, dtg, period)
    if name == "z2":
        if not point:
            raise ValueError("z2 requires a Point default geometry")
        return Z2KeySpace(geom)
    if name == "xz3":
        if not (geom and dtg):
            raise ValueError("xz3 requires a geometry and a Date field")
        return XZ3KeySpace(geom, dtg, period, sft.xz_precision)
    if name == "xz2":
        if geom is None:
            raise ValueError("xz2 requires a geometry")
        return XZ2KeySpace(geom, sft.xz_precision)
    if name == "id":
        return IdKeySpace()
    if name.startswith("attr:"):
        attr = name.split(":", 1)[1]
        if attr not in sft.attribute_names:
            raise ValueError(
                f"attribute index {name!r}: schema has no attribute {attr!r}"
            )
        return AttributeKeySpace(attr)
    raise ValueError(f"unknown index {name!r}")


def default_indices(sft: SimpleFeatureType) -> list[str]:
    """Default enabled indices for a schema (ref: GeoMesaFeatureIndexFactory
    defaults: z3+z2+id for points with time, xz3+xz2+id for non-points,
    plus attr:<name> for attributes flagged index=true)."""
    explicit = sft.user_data.get("geomesa.indices")
    if explicit:
        return [s.strip() for s in explicit.split(",") if s.strip()]
    out = []
    geom = sft.geom_field
    dtg = sft.dtg_field
    if geom is not None:
        point = sft.descriptor(geom).is_point
        if point:
            if dtg:
                out.append("z3")
            out.append("z2")
        else:
            if dtg:
                out.append("xz3")
            out.append("xz2")
    out.append("id")
    for a in sft.attributes:
        if a.indexed:
            out.append(f"attr:{a.name}")
    return out
