"""Spatial/temporal bound extraction from filters.

Copy of ``geomesa_tpu/filter/extract.py`` (ref: geomesa-filter
FilterHelper.extractGeometries / extractIntervals): given a filter and an attribute, produce the
extractable bounds (union semantics) that the key spaces turn into scan
ranges, with AND = pairwise intersection, OR = union (only if every branch
is bounded), NOT/other predicates = unbounded.

``FilterBounds.values`` is a list of per-disjunct bounds; ``unbounded=True``
means the filter does not constrain the attribute (full-domain scan);
``values == []`` with ``unbounded=False`` means provably empty (EXCLUDE).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Envelope


@dataclass(frozen=True)
class FilterBounds:
    values: tuple
    unbounded: bool = False

    @property
    def empty(self) -> bool:
        return not self.unbounded and not self.values

    @staticmethod
    def all() -> "FilterBounds":
        return FilterBounds((), unbounded=True)

    @staticmethod
    def none() -> "FilterBounds":
        return FilterBounds((), unbounded=False)


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------


def extract_geometries(f: ast.Filter, attr: str) -> FilterBounds:
    """Bounds as a union of (Envelope, exact Geometry | None) pairs. The
    envelope drives range generation; the geometry (when present) is the
    exact shape for residual evaluation."""
    if f is ast.Include:
        return FilterBounds.all()
    if f is ast.Exclude:
        return FilterBounds.none()
    if isinstance(f, ast.BBox) and f.attr == attr:
        return FilterBounds(((f.envelope, None),))
    # every relation except DISJOINT and RELATE implies the data geometry
    # meets the query geometry's envelope (a RELATE pattern can select
    # disjoint features, e.g. 'FF*FF****', so it must not prune)
    if (
        isinstance(f, ast.Intersects)
        and f.attr == attr
        and f.op not in ("disjoint", "relate")
    ):
        return FilterBounds(((f.geometry.envelope, f.geometry),))
    if isinstance(f, ast.DWithin) and f.attr == attr:
        e = f.geometry.envelope
        d = f.distance
        return FilterBounds(
            ((Envelope(e.xmin - d, e.ymin - d, e.xmax + d, e.ymax + d), None),)
        )
    if isinstance(f, ast.And):
        bounds = [extract_geometries(c, attr) for c in f.children]
        return _intersect_all(bounds, _intersect_spatial)
    if isinstance(f, ast.Or):
        bounds = [extract_geometries(c, attr) for c in f.children]
        return _union_all(bounds)
    return FilterBounds.all()


def _intersect_spatial(a, b):
    env_a, geom_a = a
    env_b, geom_b = b
    inter = env_a.intersection(env_b)
    if inter is None:
        return None
    # keep whichever exact geometry survives (both surviving is rare; the
    # residual filter still applies the full predicate set)
    return (inter, geom_a if geom_a is not None else geom_b)


# ---------------------------------------------------------------------------
# temporal
# ---------------------------------------------------------------------------

NEG_INF = -(1 << 62)
POS_INF = 1 << 62


def extract_intervals(f: ast.Filter, attr: str) -> FilterBounds:
    """Bounds as a union of inclusive (t0_ms, t1_ms) intervals."""
    if f is ast.Include:
        return FilterBounds.all()
    if f is ast.Exclude:
        return FilterBounds.none()
    if isinstance(f, ast.During) and f.attr == attr:
        return FilterBounds(((f.t0, f.t1),))
    if isinstance(f, ast.Between) and f.attr == attr:
        lo, hi = f.lo, f.hi
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
            return FilterBounds(((int(lo), int(hi)),))
        return FilterBounds.all()
    if isinstance(f, ast.Compare) and f.attr == attr and isinstance(
        f.value, (int, float)
    ):
        v = int(f.value)
        if f.op == "=":
            return FilterBounds(((v, v),))
        if f.op in (">", ">="):
            return FilterBounds(((v if f.op == ">=" else v + 1, POS_INF),))
        if f.op in ("<", "<="):
            return FilterBounds(((NEG_INF, v if f.op == "<=" else v - 1),))
        return FilterBounds.all()  # <>
    if isinstance(f, ast.And):
        return _intersect_all(
            [extract_intervals(c, attr) for c in f.children], _intersect_interval
        )
    if isinstance(f, ast.Or):
        return _union_all([extract_intervals(c, attr) for c in f.children])
    return FilterBounds.all()


def _intersect_interval(a, b):
    lo = max(a[0], b[0])
    hi = min(a[1], b[1])
    return (lo, hi) if lo <= hi else None


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------


def _intersect_all(bounds: Sequence[FilterBounds], pair_fn) -> FilterBounds:
    acc: FilterBounds | None = None
    for b in bounds:
        if b.unbounded:
            continue
        if acc is None:
            acc = b
            continue
        values = []
        for va in acc.values:
            for vb in b.values:
                v = pair_fn(va, vb)
                if v is not None:
                    values.append(v)
        acc = FilterBounds(tuple(values))
    return acc if acc is not None else FilterBounds.all()


def _union_all(bounds: Sequence[FilterBounds]) -> FilterBounds:
    values: list = []
    for b in bounds:
        if b.unbounded:
            return FilterBounds.all()
        values.extend(b.values)
    return FilterBounds(tuple(values))
