"""Query model + planner.

Copy of ``geomesa_tpu/query/plan.py`` (ref: geomesa-index-api
QueryPlanner.planQuery, FilterSplitter, StrategyDecider): ``Query``,
``QueryPlan`` with ``explain``, ``plan_query`` under the ``query.plan``
span (the range decomposition also under the ``plan.scan_ranges``
profile), the stat-based estimator, ``is_aggregate_shape``/
``aggregate_bounds``, ``as_query`` and ``internal_query``.

Planning steps: parse/normalize the filter; extract spatial + temporal +
attribute bounds; score each available index (heuristic cost, ref
StrategyDecider's stat-less fallback); generate key ranges for the winner;
split device-vs-residual predicates (the FilterTransformIterator analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.filter.compile import CompiledFilter, compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.filter.extract import (
    FilterBounds,
    extract_geometries,
    extract_intervals,
)
from geomesa_tpu_torch.index.api import KeyRange
from geomesa_tpu_torch.index.keyspaces import AttributeKeySpace, IdKeySpace


@dataclass
class Query:
    """A GeoTools-Query analog: filter + projection + limits + hints."""

    filter: "ast.Filter | str" = ast.Include
    properties: "list[str] | None" = None  # projection (transform)
    max_features: "int | None" = None
    sort_by: "str | None" = None
    sort_desc: bool = False
    hints: dict = field(default_factory=dict)  # density/stats/bin/sampling

    def parsed(self) -> ast.Filter:
        if isinstance(self.filter, str):
            return parse_ecql(self.filter)
        return self.filter


@dataclass
class QueryPlan:
    """The chosen strategy + ranges + filter split (explain() payload)."""

    sft: SimpleFeatureType
    query: Query
    filter: ast.Filter
    index_name: str
    ranges: "list[KeyRange] | None"
    compiled: CompiledFilter
    geom_bounds: FilterBounds
    time_bounds: FilterBounds
    candidates: "list[tuple[str, float]]" = field(default_factory=list)
    #: aggregation-pushdown routing hint (:func:`aggregate_bounds`):
    #: ``(envelopes, intervals)`` when the filter is EXACTLY a bbox+time
    #: conjunction, so chunk-tolerant density/count/stats queries may be
    #: answered from the v2 manifest's chunk pre-aggregates (interior
    #: chunks from summaries, boundary chunks row-refined). None = the
    #: filter has structure the chunk stats cannot decide -- row scan.
    agg_bounds: "tuple | None" = None

    def explain(self) -> str:
        """Human-readable plan dump (ref: Explainer output surfaced by the
        CLI 'explain' command)."""
        lines = [
            f"Planning query on '{self.sft.type_name}'",
            f"  Filter: {self.filter!r}",
            f"  Strategy candidates: "
            + ", ".join(f"{n} (cost {c:g})" for n, c in self.candidates),
            f"  Chosen index: {self.index_name}",
        ]
        if self.ranges is None:
            lines.append("  Ranges: FULL SCAN (no extractable bounds)")
        else:
            lines.append(f"  Ranges: {len(self.ranges)}")
            for r in self.ranges[:5]:
                lines.append(f"    {r.lo} .. {r.hi}{' (contained)' if r.contained else ''}")
            if len(self.ranges) > 5:
                lines.append(f"    ... {len(self.ranges) - 5} more")
        lines.append(f"  Device predicate: {self.compiled.device_part!r}")
        lines.append(f"  Host residual:    {self.compiled.residual_part!r}")
        return "\n".join(lines)


def plan_query(
    sft: SimpleFeatureType,
    indices: dict,
    query: Query,
    max_ranges: "int | None" = None,
    data_interval: "tuple[int, int] | None" = None,
    stats: "object | None" = None,
) -> QueryPlan:
    """indices: {name: BuiltIndex | IndexKeySpace} -- planning only needs
    the key spaces, so disk-backed stores can plan before loading data.

    The interceptor chain (query/interceptor.py) rewrites the
    query before planning and can veto the finished plan; ``max_ranges``
    defaults to the three-tier config resolution (SFT user-data
    ``geomesa.scan.ranges.target``, then the system property)."""
    from geomesa_tpu_torch.tracing import span as trace_span

    with trace_span("query.plan", type=sft.type_name) as _tsp:
        return _plan_query(
            sft, indices, query, max_ranges, data_interval, stats, _tsp
        )


def _plan_query(
    sft, indices, query, max_ranges, data_interval, stats, _tsp
) -> QueryPlan:
    from geomesa_tpu_torch.conf import sys_prop
    from geomesa_tpu_torch.query.interceptor import (
        apply_interceptors,
        guard_plan,
        interceptors_for,
    )

    chain = interceptors_for(sft)
    query = apply_interceptors(chain, query, sft)
    if max_ranges is None:
        ud = sft.user_data or {}
        max_ranges = int(
            ud.get("geomesa.scan.ranges.target") or sys_prop("scan.ranges.target")
        )
    f = query.parsed()
    geom_field = sft.geom_field
    dtg_field = sft.dtg_field
    geoms = (
        extract_geometries(f, geom_field) if geom_field else FilterBounds.all()
    )
    intervals = (
        extract_intervals(f, dtg_field) if dtg_field else FilterBounds.all()
    )

    # score every index (ref StrategyDecider: stat-based when stats exist,
    # heuristic otherwise)
    est = _StatEstimator.build(stats) if stats is not None else None
    candidates: list[tuple[str, float]] = []
    for name, built in indices.items():
        ks = getattr(built, "keyspace", built)
        if isinstance(ks, AttributeKeySpace):
            bounds = extract_intervals(f, ks.attr)
            eq = _attr_equality(f, ks.attr)
            if est is not None:
                cost = est.attr_cost(ks.attr, eq, bounds)
            else:
                cost = (
                    0.5 if eq else (5.0 if not bounds.unbounded else float("inf"))
                )
            candidates.append((name, cost))
        elif isinstance(ks, IdKeySpace):
            candidates.append((name, float("inf")))
        else:
            heuristic = ks.cost(geoms, intervals)
            if est is not None and heuristic != float("inf"):
                cost = est.spatial_cost(ks, geoms, intervals)
                if cost is None:
                    cost = heuristic
            else:
                cost = heuristic
            candidates.append((name, cost))
    # full scan fallback uses whichever index exists
    candidates.sort(key=lambda t: t[1])
    index_name = candidates[0][0] if candidates else None
    if index_name is None:
        raise ValueError("no indices available")
    if candidates[0][1] == float("inf"):
        # nothing prunes: full scan on the first index
        ranges = None
    else:
        built = indices[index_name]
        ks = getattr(built, "keyspace", built)
        if isinstance(ks, AttributeKeySpace):
            bounds = extract_intervals(f, ks.attr)
            eq = _attr_equality(f, ks.attr)
            if eq is not None:
                ranges = [KeyRange((v,), (v,), False) for v in eq]
            else:
                ranges = ks.ranges_for_values(bounds)
        else:
            from geomesa_tpu_torch.profiling import profile

            with profile("plan.scan_ranges"):
                ranges = ks.scan_ranges(
                    geoms, intervals, max_ranges, data_interval=data_interval
                )
    compiled = compile_filter(f, sft)
    plan = QueryPlan(
        sft=sft,
        query=query,
        filter=f,
        index_name=index_name,
        ranges=ranges,
        compiled=compiled,
        geom_bounds=geoms,
        time_bounds=intervals,
        candidates=candidates,
        agg_bounds=aggregate_bounds(f, sft, geoms, intervals),
    )
    guard_plan(chain, plan)
    _tsp.set(
        index=index_name,
        ranges=len(ranges) if ranges is not None else "full-scan",
    )
    return plan


def is_aggregate_shape(f, sft) -> bool:
    """Structural half of :func:`aggregate_bounds` -- True when ``f`` is
    a conjunction of envelope predicates on the default geometry and
    closed intervals on the default dtg (or INCLUDE). Cheap (no bound
    extraction, no planning): pushdown entry points pre-screen with this
    before paying for a full query plan they would then discard."""
    geom_field = sft.geom_field
    dtg_field = sft.dtg_field

    def _pure(node) -> bool:
        if node is ast.Include:
            return True
        if isinstance(node, ast.BBox) and node.attr == geom_field:
            return True
        if isinstance(node, ast.During) and node.attr == dtg_field:
            return True
        if (
            isinstance(node, ast.Between)
            and node.attr == dtg_field
            and isinstance(node.lo, (int, float))
            and isinstance(node.hi, (int, float))
        ):
            return True
        return False

    nodes = f.children if isinstance(f, ast.And) else (f,)
    return all(_pure(n) for n in nodes)


def aggregate_bounds(f, sft, geoms, intervals) -> "tuple | None":
    """The planner's aggregation-pushdown routing test: ``(envs, ivals)``
    when ``f`` is EXACTLY a conjunction of envelope predicates on the
    default geometry and closed intervals on the default dtg (or
    INCLUDE) -- the shapes chunk statistics can decide. ``envs``/
    ``ivals`` follow the classify() convention: None = unconstrained on
    that dimension, an empty tuple = provably empty. Any other filter
    structure (attribute predicates, NOT, OR, exact geometries, open
    comparisons) returns None and aggregates take the row-scan path.

    Soundness: an INTERIOR chunk (bbox inside one envelope, time range
    inside one interval) then contains ONLY rows satisfying ``f`` --
    a feature's envelope lies within its chunk's bbox, so containment
    implies the bbox predicate for point and extent geometries alike."""
    if not is_aggregate_shape(f, sft):
        return None
    envs = (
        None
        if geoms.unbounded
        else tuple(env for env, _ in geoms.values)
    )
    ivals = None if intervals.unbounded else tuple(intervals.values)
    return (envs, ivals)


class _StatEstimator:
    """Stat-based candidate costing (ref StrategyDecider + GeoMesaStats):
    costs are estimated rows scanned, derived from the write-time stats
    (CountStat total, per-attribute MinMax, Z3Histogram occupancy)."""

    def __init__(self, total, minmax, z3hist, cardinality):
        self.total = total
        self.minmax = minmax  # attr -> MinMax
        self.z3hist = z3hist
        self.cardinality = cardinality  # attr -> Cardinality (HLL)

    @staticmethod
    def build(stats) -> "_StatEstimator | None":
        from geomesa_tpu_torch.stats.sketches import (
            Cardinality,
            CountStat,
            MinMax,
            Z3HistogramStat,
        )

        total = None
        minmax: dict = {}
        z3hist = None
        cardinality: dict = {}
        for s in getattr(stats, "stats", []):
            if isinstance(s, CountStat):
                total = s.count
            elif isinstance(s, MinMax):
                minmax[s.attr] = s
            elif isinstance(s, Z3HistogramStat):
                z3hist = s
            elif isinstance(s, Cardinality):
                cardinality[s.attr] = s
        if total is None:
            return None
        return _StatEstimator(total, minmax, z3hist, cardinality)

    def attr_cost(self, attr, eq, bounds) -> float:
        if eq is not None:
            card = self.cardinality.get(attr)
            distinct = card.estimate if card is not None else 0.0
            if distinct >= 1.0:
                # rows per distinct value x values requested (HLL-backed)
                per_value = self.total / distinct
            else:
                per_value = self.total * 0.001  # high-cardinality guess
            return max(1.0, min(self.total, per_value * len(eq)))
        if bounds.unbounded:
            return float("inf")
        mm = self.minmax.get(attr)
        if mm is None:
            return self.total * 0.5
        frac = 0.0
        for lo, hi in bounds.values:
            frac += mm.selectivity(lo, hi)
        return self.total * min(1.0, frac)

    def _time_fraction(self, ks, intervals) -> float:
        mm = self.minmax.get(getattr(ks, "dtg_field", None))
        if mm is None:
            return 1.0
        return min(
            1.0, sum(mm.selectivity(lo, hi) for lo, hi in intervals.values)
        )

    def spatial_cost(self, ks, geoms, intervals) -> "float | None":
        """Estimated rows for z3/xz3 (occupancy histogram) and z2/xz2
        (time-marginalized histogram, area-fraction fallback). Always in
        rows so candidates stay comparable with attribute estimates; all
        spatial candidates share the same data-aware model so clustered
        data cannot bias the choice. None only when no estimate is
        possible at all."""
        # structural: temporal keyspaces (z3/xz3) carry a dtg_field
        needs_time = getattr(ks, "dtg_field", None) is not None
        if geoms.empty or (needs_time and intervals.empty):
            return 1.0
        if needs_time and intervals.unbounded:
            return None  # keyspace cost is inf anyway
        if geoms.unbounded:
            # no spatial prune: rows bounded only by the time fraction
            tfrac = self._time_fraction(ks, intervals) if needs_time else 1.0
            return max(1.0, self.total * tfrac)
        if self.z3hist is not None:
            if needs_time:
                est = self.z3hist.estimate(geoms.values, intervals.values)
            else:
                est = self.z3hist.estimate_spatial(geoms.values)
            return max(1.0, est)
        # area-fraction fallback (no histogram: non-point or no-time schema)
        area = 0.0
        for env, _ in geoms.values:
            w = max(0.0, min(env.xmax, 180.0) - max(env.xmin, -180.0))
            h = max(0.0, min(env.ymax, 90.0) - max(env.ymin, -90.0))
            area += w * h
        frac = min(1.0, area / (360.0 * 180.0))
        if needs_time:
            frac *= self._time_fraction(ks, intervals)
        return max(1.0, self.total * frac)


def as_query(q) -> Query:
    """Coerce a Query | ECQL string | ast.Filter to a Query (shared by all
    store implementations)."""
    if isinstance(q, Query):
        return q
    return Query(filter=q)


def internal_query(f, auths=None) -> Query:
    """A maintenance/candidate-scan query: exempt from user-facing caps
    like the global ``query.max.features`` (truncating an age-off sweep or
    a kNN candidate scan would corrupt the result). ``auths`` carries the
    caller's row-security context — omitted means none (fail closed)."""
    hints = {"internal": True}
    if auths is not None:
        hints["auths"] = auths
    return Query(filter=f, hints=hints)


def _attr_equality(f: ast.Filter, attr: str):
    """Equality/IN value set for an attribute if the filter pins it
    (top-level or within an AND), else None."""
    nodes = f.children if isinstance(f, ast.And) else (f,)
    for n in nodes:
        if isinstance(n, ast.Compare) and n.op == "=" and n.attr == attr:
            return (n.value,)
        if isinstance(n, ast.In) and n.attr == attr:
            return tuple(sorted(n.values))
    return None
