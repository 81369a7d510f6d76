"""Filter compilation: AST -> vectorized evaluators.

Counterpart of ``geomesa_tpu/filter/compile.py``. Two targets:

- **host**: exact numpy evaluation over a FeatureBatch (``evaluate_host``)
  -- the oracle and the residual evaluator.
- **device**: the filter's device-scannable conjuncts, fused into one scan
  over the resident planes. The filter is CNF-split: supported conjuncts
  form the device part; the rest is the host residual applied to the
  device-surviving candidates.

The selection rule of the counterpart's ``CompiledFilter.jitted_scan``
lives in :meth:`CompiledFilter.count`/:meth:`CompiledFilter.mask`: a
device part the filter-scan encoder accepts runs through the filter-scan
kernel (its plain version for CPU tensors); one it refuses
(``PallasUnsupported``, decided statically when the filter compiles)
runs through the plain ``device_fn``, counted on
``kernels.DEVICE_FN_CALLS``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Point, Polygon, points_in_polygon
from geomesa_tpu_torch.ops import filter_scan

_RELATIONS_LATER = (
    "DE-9IM relation predicates (crosses/touches/overlaps/equals/relate) "
    "are a later port slice (ROADMAP, port queue: stats/knn/joins)"
)


# ---------------------------------------------------------------------------
# host (exact, numpy)
# ---------------------------------------------------------------------------


def evaluate_host(f: ast.Filter, batch: FeatureBatch) -> np.ndarray:
    """Exact boolean mask for the full filter over a batch."""
    n = len(batch)
    if f is ast.Include:
        return np.ones(n, dtype=bool)
    if f is ast.Exclude:
        return np.zeros(n, dtype=bool)
    if isinstance(f, ast.And):
        m = np.ones(n, dtype=bool)
        for c in f.children:
            m &= evaluate_host(c, batch)
        return m
    if isinstance(f, ast.Or):
        m = np.zeros(n, dtype=bool)
        for c in f.children:
            m |= evaluate_host(c, batch)
        return m
    if isinstance(f, ast.Not):
        return ~evaluate_host(f.child, batch)
    if isinstance(f, ast.BBox):
        x, y = batch.point_coords(f.attr)
        return (x >= f.xmin) & (x <= f.xmax) & (y >= f.ymin) & (y <= f.ymax)
    if isinstance(f, (ast.Intersects, ast.DWithin)):
        return _host_spatial(f, batch)
    if isinstance(f, ast.During):
        col = batch.column(f.attr)
        return (col >= f.t0) & (col <= f.t1)
    if isinstance(f, ast.Between):
        col = batch.column(f.attr)
        return (col >= f.lo) & (col <= f.hi)
    if isinstance(f, ast.Compare):
        col = batch.column(f.attr)
        v = f.value
        return {
            "=": lambda: col == v,
            "<>": lambda: col != v,
            "<": lambda: col < v,
            "<=": lambda: col <= v,
            ">": lambda: col > v,
            ">=": lambda: col >= v,
        }[f.op]()
    if isinstance(f, ast.In):
        col = batch.column(f.attr)
        return np.isin(
            col,
            np.array(
                list(f.values),
                dtype=col.dtype if col.dtype != object else object,
            ),
        )
    if isinstance(f, ast.Like):
        col = batch.column(f.attr)
        pat = re.compile(f.regex())
        return np.array(
            [v is not None and pat.match(str(v)) is not None for v in col],
            dtype=bool,
        )
    if isinstance(f, ast.IsNull):
        col = batch.column(f.attr)
        if col.dtype == object:
            m = np.array([v is None for v in col], dtype=bool)
        else:
            m = np.zeros(len(col), dtype=bool)
        return ~m if f.negate else m
    raise TypeError(f"cannot evaluate {type(f)}")


def _host_spatial(f, batch: FeatureBatch) -> np.ndarray:
    """Point-data spatial predicates (non-point data cannot be staged in
    this slice: FeatureBatch refuses it)."""
    geom = f.geometry
    x, y = batch.point_coords(f.attr)
    if isinstance(f, ast.DWithin):
        if isinstance(geom, Point):
            return (x - geom.x) ** 2 + (y - geom.y) ** 2 <= f.distance**2
        e = geom.envelope
        return (
            (x >= e.xmin - f.distance) & (x <= e.xmax + f.distance)
            & (y >= e.ymin - f.distance) & (y <= e.ymax + f.distance)
        )
    if f.op in ("crosses", "touches", "overlaps", "equals", "relate"):
        raise NotImplementedError(_RELATIONS_LATER)
    if f.op == "contains" and not isinstance(geom, Point):
        return np.zeros(len(batch), dtype=bool)  # a point contains points only
    if isinstance(geom, Point):
        m = (x == geom.x) & (y == geom.y)
    elif hasattr(geom, "rings"):
        if isinstance(geom, Polygon):
            m = points_in_polygon(x, y, geom.rings())
        else:
            m = np.zeros(len(x), dtype=bool)
            for p in getattr(geom, "polygons", ()):
                m |= points_in_polygon(x, y, p.rings())
    else:  # linestring vs point: envelope fallback
        e = geom.envelope
        m = (x >= e.xmin) & (x <= e.xmax) & (y >= e.ymin) & (y <= e.ymax)
    return ~m if f.op == "disjoint" else m


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def _device_supported(f: ast.Filter, sft: SimpleFeatureType) -> bool:
    if f in (ast.Include, ast.Exclude):
        return True
    if isinstance(f, (ast.And, ast.Or)):
        return all(_device_supported(c, sft) for c in f.children)
    if isinstance(f, ast.Not):
        return _device_supported(f.child, sft)
    if isinstance(f, ast.BBox):
        return sft.descriptor(f.attr).is_geometry
    if isinstance(f, ast.Intersects):
        return (
            sft.descriptor(f.attr).is_point
            and hasattr(f.geometry, "rings")
            and f.op in ("intersects", "within", "disjoint")
        )
    if isinstance(f, ast.DWithin):
        return sft.descriptor(f.attr).is_geometry
    if isinstance(f, (ast.During, ast.Between)):
        dtype = sft.descriptor(f.attr).column_dtype
        return dtype is not None and dtype != np.bool_
    if isinstance(f, (ast.Compare, ast.In)):
        dtype = sft.descriptor(f.attr).column_dtype
        return (
            dtype is not None
            and dtype != np.bool_
            and all(
                isinstance(v, (int, float))
                for v in (f.values if isinstance(f, ast.In) else (f.value,))
            )
        )
    return False


def _is_i64(sft: SimpleFeatureType, attr: str) -> bool:
    return sft.descriptor(attr).column_dtype == np.int64


def device_columns_for(f: ast.Filter, sft: SimpleFeatureType) -> list[str]:
    """Device column names needed: ``attr`` for scalars, ``attr__x/__y`` for
    point geometries, ``attr__x0..__y1`` envelope planes for other
    geometries, ``attr__hi/__lo`` planes for int64 scalars."""
    cols: list[str] = []
    for attr in sorted(ast.attributes_of(f)):
        desc = sft.descriptor(attr)
        if desc.is_point:
            cols += [f"{attr}__x", f"{attr}__y"]
        elif desc.is_geometry:
            cols += [f"{attr}__x0", f"{attr}__y0",
                     f"{attr}__x1", f"{attr}__y1"]
        elif desc.column_dtype == np.int64:
            cols += [f"{attr}__hi", f"{attr}__lo"]
        elif desc.column_dtype is not None:
            cols.append(attr)
    return cols


def build_device_fn(f: ast.Filter, sft: SimpleFeatureType) -> Callable:
    """AST -> fn(cols: dict[str, Tensor]) -> bool mask, in plain tensor ops
    on the columns' device (the counterpart's XLA ``device_fn``). Caller
    must have checked _device_supported."""
    prog = filter_scan.encode_device_program(f, sft, device_columns_for(f, sft))

    def device_fn(cols: dict) -> torch.Tensor:
        n = int(next(iter(cols.values())).shape[0]) if cols else 0
        return filter_scan.run_program_plain(prog, cols, n=n)

    return device_fn


# ---------------------------------------------------------------------------
# CompiledFilter
# ---------------------------------------------------------------------------


@dataclass
class CompiledFilter:
    filter: ast.Filter
    sft: SimpleFeatureType
    device_part: ast.Filter  # conjuncts evaluable on device
    residual_part: ast.Filter  # exact host remainder (Include if none)
    device_fn: Callable  # dict[str, Tensor] -> bool mask
    device_cols: list
    program: "filter_scan.Program | None"  # None: the kernel refused it

    @property
    def fully_on_device(self) -> bool:
        return self.residual_part is ast.Include

    def count(self, cols: dict) -> torch.Tensor:
        """int32 count of the device part over the staged columns."""
        if self.program is not None:
            return filter_scan.filter_scan_count(self.program, cols)
        kernels.DEVICE_FN_CALLS["count"] += 1
        return self.device_fn(cols).sum(dtype=torch.int32)

    def mask(self, cols: dict) -> torch.Tensor:
        """bool mask of the device part over the staged columns."""
        if self.program is not None:
            return filter_scan.filter_scan_mask(self.program, cols)
        kernels.DEVICE_FN_CALLS["mask"] += 1
        return self.device_fn(cols)

    def host_mask(self, batch: FeatureBatch) -> np.ndarray:
        """Exact full-filter mask (oracle path)."""
        return evaluate_host(self.filter, batch)

    def residual_mask(self, batch: FeatureBatch) -> np.ndarray:
        return evaluate_host(self.residual_part, batch)


def _envelope_prefilter(c: ast.Filter, sft: SimpleFeatureType):
    """Device BBox prefilter implied by a residual spatial conjunct, or
    None (everything but disjoint/relate, whose hits need not intersect
    the query envelope)."""
    if isinstance(c, ast.Intersects) and c.op in (
        "intersects", "within", "contains", "crosses", "touches",
        "overlaps", "equals",
    ):
        if not sft.descriptor(c.attr).is_geometry:
            return None
        e = c.geometry.envelope
        return ast.BBox(c.attr, e.xmin, e.ymin, e.xmax, e.ymax)
    return None


def compile_filter(f: ast.Filter, sft: SimpleFeatureType) -> CompiledFilter:
    conjuncts = list(f.children) if isinstance(f, ast.And) else [f]
    dev = [c for c in conjuncts if _device_supported(c, sft)]
    res = [c for c in conjuncts if not _device_supported(c, sft)]
    for c in res:
        pre = _envelope_prefilter(c, sft)
        if pre is not None and _device_supported(pre, sft):
            dev.append(pre)
    device_part: ast.Filter = (
        ast.Include if not dev else (dev[0] if len(dev) == 1 else ast.And(tuple(dev)))
    )
    residual_part: ast.Filter = (
        ast.Include if not res else (res[0] if len(res) == 1 else ast.And(tuple(res)))
    )
    try:
        program = filter_scan.encode_kernel_program(device_part, sft)
    except filter_scan.PallasUnsupported:
        program = None  # static choice: device_fn serves this filter
    return CompiledFilter(
        filter=f,
        sft=sft,
        device_part=device_part,
        residual_part=residual_part,
        device_fn=build_device_fn(device_part, sft),
        device_cols=device_columns_for(device_part, sft),
        program=program,
    )
