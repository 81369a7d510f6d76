"""Aggregation pushdown over chunk statistics (partition format v2).

Copy of ``geomesa_tpu/store/pushdown.py`` (ref: geomesa-accumulo
DensityIterator / StatsIterator, aggregates computed next to the data).
v2 partitions carry per-chunk pre-aggregates (store/chunkstats.py), so a
bbox+time aggregate decomposes as

- **interior** chunks (bbox inside one query envelope, time range inside
  one interval): answered from the manifest summary, rows never read,
- **boundary** chunks: read (chunk-selective) and refined row by row with
  the exact filter through the runner, so through the filter-scan kernel,
- **disjoint** chunks: skipped.

Count and stats (Count/MinMax specs) are EXACT under this split. Density
is exact in total mass and within coarse-cell tolerance in placement
(interior cells prorate uniformly within a world-grid cell; boundary rows
rasterize through ``process/density.py`` ``_density_host``). A viewport
of zero width or height refines every chunk the plan keeps and places the
rows on its line as the resident path does; the counterpart divides by
the zero extent (ROADMAP section 3).

Routing: the planner's ``QueryPlan.agg_bounds`` (None = structure chunk
stats cannot decide: the row scan), the ``store.chunk.pushdown`` property
and a per-query ``hints={"agg.pushdown": False}`` veto. All entry points
require the store's shared lock held by the caller; the
FileSystemDataStore methods wrap them. ``verify_chunk_stats`` checks the
partition files' chunk blocks where the counterpart checks Parquet row
groups.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.api import BuiltIndex, PartitionMeta
from geomesa_tpu_torch.index.keyspaces import keyspace_for
from geomesa_tpu_torch.ops.density import corners
from geomesa_tpu_torch.store import chunkstats as cks

#: query hints that cannot change a pushdown answer -- anything else
#: (sampling, projection hooks, unknown extensions) forces the row scan
_INERT_HINTS = frozenset({"auths", "internal", "agg.pushdown"})


def _plan_for(store, type_name: str, query):
    from geomesa_tpu_torch.query.plan import as_query, is_aggregate_shape

    q = as_query(query)
    if q.hints.get("agg.pushdown") is False:
        return None, q
    if q.max_features is not None or q.properties:
        return None, q  # caps/projections have row-level semantics
    if any(k not in _INERT_HINTS for k in q.hints):
        return None, q
    from geomesa_tpu_torch.conf import sys_prop

    if not sys_prop("store.chunk.pushdown"):
        return None, q
    # structural pre-screen BEFORE planning: an attribute/OR/NOT filter
    # can never push down, and planning it here just to discard the
    # plan would double the fallback's planning cost (the row-scan
    # path plans again). Interceptors may rewrite the query during
    # planning, but only ever toward MORE structure (caps, rewrites),
    # which the post-plan agg_bounds/max_features checks still catch.
    if not is_aggregate_shape(q.parsed(), store.get_schema(type_name)):
        return None, q
    plan = store._plan_locked(type_name, q)
    if plan.agg_bounds is None:
        return None, q
    if plan.query.max_features is not None:
        # an interceptor (global query.max.features) capped the query
        # during planning: caps have row-level semantics
        return None, q
    return plan, q


def _eligible_parts(store, type_name: str, plan):
    """The pruned partition list when EVERY surviving partition carries
    chunk stats and none holds visibility-labeled rows (pushdown cannot
    see labels, so it must not skip rows a visibility filter would
    hide). None = fall back."""
    parts = store._pruned_parts(type_name, plan)
    for p in parts:
        if p.chunks is None or p.chunks.has_vis:
            return None
    return parts


def _classify(plan, cs):
    envs, ivals = plan.agg_bounds
    return cks.classify(cs, envs, ivals)


def _refine_batch(store, type_name: str, p, sel, plan, ks):
    """Read the boundary chunks of one partition (chunk-selective) and
    return the rows surviving the EXACT filter -- the same single-
    partition runner wrap the row-scan query path uses."""
    import dataclasses

    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.query.runner import run_query

    from geomesa_tpu_torch.device import resolve_device

    batch = store._read_partition_unlocked(
        type_name, p, cache=False, chunk_sel=sel
    )
    inner_plan = dataclasses.replace(plan, query=Query(filter=plan.filter))
    local = BuiltIndex(
        ks,
        batch,
        {},
        [PartitionMeta(0, 0, len(batch), p.key_lo, p.key_hi, len(batch))],
    )
    return run_query(local, inner_plan, resolve_device(store.device),
                     defer_visibility=True).batch


def _boundary_sel(plan, cs, klass) -> list:
    """Boundary-chunk indices, additionally Z-range pruned: a chunk can
    meet the query's bbox without containing any key the planner's
    ranges cover."""
    sel = np.nonzero(klass == cks.BOUNDARY)[0]
    if len(sel) and plan.ranges is not None:
        keep = cks.chunks_overlapping(cs, plan.ranges)
        sel = sel[keep[sel]]
    return [int(i) for i in sel]


def count_pushdown(store, type_name: str, query) -> "tuple | None":
    """Exact filtered count from chunk pre-aggregates as ``(count,
    plan)``, or None for the row-scan fallback. Caller holds the
    store's shared lock (and audits the answer — a pushdown-served
    count must appear in the audit log exactly like a scanned one)."""
    from geomesa_tpu_torch import metrics
    from geomesa_tpu_torch.tracing import span

    plan, q = _plan_for(store, type_name, query)
    if plan is None:
        return None
    parts = _eligible_parts(store, type_name, plan)
    if parts is None:
        metrics.agg_pushdown_fallbacks.inc(kind="count")
        return None
    st = store._types[type_name]
    ks = keyspace_for(st.sft, st.primary)
    total = 0
    pre_rows = 0
    refined_chunks = 0
    with span("agg.pushdown", kind="count", type=type_name) as sp:
        for p in parts:
            cs = p.chunks
            klass = _classify(plan, cs)
            interior = int(cs.rows[klass == cks.INTERIOR].sum())
            total += interior
            pre_rows += interior
            sel = _boundary_sel(plan, cs, klass)
            if sel:
                refined_chunks += len(sel)
                total += len(
                    _refine_batch(store, type_name, p, sel, plan, ks)
                )
        sp.set(rows_preagg=pre_rows, chunks_refined=refined_chunks)
    metrics.agg_pushdown_queries.inc(kind="count")
    metrics.agg_pushdown_rows.inc(pre_rows)
    if refined_chunks:
        metrics.agg_pushdown_chunks_refined.inc(refined_chunks)
    return int(total), plan


def density_pushdown(
    store, type_name: str, query, envelope, width: int, height: int
) -> "np.ndarray | None":
    """(height, width) float32 density grid from chunk pre-aggregates,
    or None for the row-scan fallback. Caller holds the shared lock.

    Density is the tolerant aggregate (the caller asked for a raster,
    not rows), so the read-avoidance bar is lower than count's: a chunk
    whose TIME range is fully inside a query interval is answered
    entirely from its coarse world-grid cells — cells inside the
    envelope count fully (exact), cells straddling the envelope/raster
    edge prorate by area overlap (the uniform-within-cell assumption).
    No read, regardless of the chunk's spatial extent. Only chunks whose
    time range straddles an interval boundary descend to row-level
    refinement (their cells cannot say WHICH rows are in-interval);
    chunks disjoint in space or time are skipped. With an
    envelope/raster aligned to the coarse grid there are no straddling
    cells and the result is mass-exact; otherwise edge cells carry the
    documented grid-cell tolerance."""
    from geomesa_tpu_torch import metrics
    from geomesa_tpu_torch.tracing import span

    plan, q = _plan_for(store, type_name, query)
    if plan is None:
        return None
    sft = store.get_schema(type_name)
    geom = sft.geom_field
    if geom is None or not sft.descriptor(geom).is_point:
        return None  # coarse cells count point locations only
    parts = _eligible_parts(store, type_name, plan)
    if parts is None:
        metrics.agg_pushdown_fallbacks.inc(kind="density")
        return None
    grid_n = None
    for p in parts:
        g = p.chunks.grid
        if grid_n is None:
            grid_n = g
        elif g != grid_n:
            # mixed grids (a store.chunk.grid change mid-history): the
            # proration matrices assume one resolution — row scan
            metrics.agg_pushdown_fallbacks.inc(kind="density")
            return None
    envs, ivals = plan.agg_bounds
    st = store._types[type_name]
    ks = keyspace_for(st.sft, st.primary)
    # a viewport of zero width or height counts the rows on its line (the
    # resident rule, ``ops/density.py`` ``viewport(..., lines=True)``):
    # the coarse cells cannot say which rows lie on a line, so every chunk
    # the plan keeps refines at row level
    xmin, ymin, xmax, ymax = corners(envelope)
    line = xmax >= xmin and ymax >= ymin and (xmax == xmin or ymax == ymin)
    out = np.zeros((height, width), dtype=np.float32)
    coarse = None
    pre_rows = 0
    refined_chunks = 0
    with span("agg.pushdown", kind="density", type=type_name) as sp:
        for p in parts:
            cs = p.chunks
            klass = _classify(plan, cs)  # spatial+time, for DISJOINT
            t_klass = cks.classify(cs, None, ivals)  # time alone
            for ci in range(len(cs)):
                if klass[ci] == cks.DISJOINT:
                    continue
                if (
                    not line
                    and t_klass[ci] == cks.INTERIOR
                    and (len(cs.cells[ci]) or not cs.rows[ci])
                    # a non-finite bbox means NaN coordinates polluted
                    # the chunk's cell histogram at build time: those
                    # rows must row-refine (the exact path drops NaN
                    # rows from the raster; the cells cannot)
                    and (
                        cs.bbox is None
                        or bool(np.isfinite(cs.bbox[ci]).all())
                    )
                ):
                    if coarse is None:
                        coarse = np.zeros(
                            grid_n * grid_n, dtype=np.float64
                        )
                    coarse[cs.cells[ci]] += cs.cell_counts[ci]
                    pre_rows += int(cs.rows[ci])
                    klass[ci] = cks.INTERIOR  # answered; never refine
                else:
                    # time straddles (or a drifted manifest lost the
                    # histogram): row-level refinement, never mass loss
                    klass[ci] = cks.BOUNDARY
            sel = _boundary_sel(plan, cs, klass)
            if sel:
                refined_chunks += len(sel)
                hits = _refine_batch(store, type_name, p, sel, plan, ks)
                if len(hits):
                    from geomesa_tpu_torch.process.density import _density_host

                    x, y = hits.point_coords()
                    out += _density_host(
                        x, y, np.ones(len(hits)), envelope, width, height
                    )
        if coarse is not None:
            out += _cells_to_raster(
                coarse.reshape(grid_n, grid_n),
                grid_n,
                envs,
                envelope,
                width,
                height,
            )
        sp.set(rows_preagg=pre_rows, chunks_refined=refined_chunks)
    metrics.agg_pushdown_queries.inc(kind="density")
    metrics.agg_pushdown_rows.inc(pre_rows)
    if refined_chunks:
        metrics.agg_pushdown_chunks_refined.inc(refined_chunks)
    return out


def _cells_to_raster(coarse, grid_n, envs, envelope, width, height):
    """Pre-aggregated cells -> raster: restrict the coarse counts to the
    query envelopes (cells fully outside drop, straddling cells keep the
    overlapping area fraction — uniform-within-cell), then prorate onto
    the raster pixels."""
    if envs is not None:
        frac = np.zeros((grid_n, grid_n), dtype=np.float64)
        for e in envs:
            fx = cks._overlap_matrix(
                grid_n, cks.WORLD[0], cks.WORLD[2], e.xmin, e.xmax, 1
            )[:, 0]
            fy = cks._overlap_matrix(
                grid_n, cks.WORLD[1], cks.WORLD[3], e.ymin, e.ymax, 1
            )[:, 0]
            frac = np.maximum(frac, fy[:, None] * fx[None, :])
        coarse = coarse * np.clip(frac, 0.0, 1.0)
    return cks.prorate_coarse(coarse, grid_n, envelope, width, height)


def stats_pushdown(
    store, type_name: str, query, stat_spec: str
):
    """SeqStat from chunk partials for Count/MinMax specs (exact), or
    None for the row-scan fallback. Caller holds the shared lock."""
    from geomesa_tpu_torch import metrics
    from geomesa_tpu_torch.stats import parse_stat
    from geomesa_tpu_torch.stats.sketches import CountStat, MinMax, stat_from_json
    from geomesa_tpu_torch.tracing import span

    seq = parse_stat(stat_spec)
    if not all(isinstance(s, (CountStat, MinMax)) for s in seq.stats):
        return None  # only the sketches chunk partials carry
    plan, q = _plan_for(store, type_name, query)
    if plan is None:
        return None
    covered = {
        rec["attr"]
        for p in store._types[type_name].partitions
        if p.chunks is not None
        for part in p.chunks.partials[:1]
        for rec in part
    }
    for s in seq.stats:
        if isinstance(s, MinMax) and s.attr not in covered:
            return None  # no partial recorded for this attribute
    parts = _eligible_parts(store, type_name, plan)
    if parts is None:
        metrics.agg_pushdown_fallbacks.inc(kind="stats")
        return None
    st = store._types[type_name]
    ks = keyspace_for(st.sft, st.primary)
    pre_rows = 0
    refined_chunks = 0
    with span("agg.pushdown", kind="stats", type=type_name) as sp:
        for p in parts:
            cs = p.chunks
            klass = _classify(plan, cs)
            for ci in np.nonzero(klass == cks.INTERIOR)[0]:
                rows = int(cs.rows[ci])
                pre_rows += rows
                partial = {
                    rec["attr"]: rec for rec in cs.partials[ci]
                }
                for s in seq.stats:
                    if isinstance(s, CountStat):
                        s.count += rows
                    else:
                        rec = partial.get(s.attr)
                        if rec is not None:
                            s.merge(stat_from_json(rec))
            sel = _boundary_sel(plan, cs, klass)
            if sel:
                refined_chunks += len(sel)
                hits = _refine_batch(store, type_name, p, sel, plan, ks)
                if len(hits):
                    seq.observe_batch(hits)
        sp.set(rows_preagg=pre_rows, chunks_refined=refined_chunks)
    metrics.agg_pushdown_queries.inc(kind="stats")
    metrics.agg_pushdown_rows.inc(pre_rows)
    if refined_chunks:
        metrics.agg_pushdown_chunks_refined.inc(refined_chunks)
    return seq


# -- fsck cross-check --------------------------------------------------------


def verify_chunk_stats(store, type_name: str) -> "list[tuple]":
    """Cross-check every v2 partition's chunk statistics against its
    decoded rows: per-chunk row counts, key min/max (recomputed through
    the key space), bbox, time range, density-cell mass and MinMax
    partials, plus parquet row-group alignment. Returns
    ``[(pid, chunk_index, error)]`` -- drifted stats mean pruning and
    pushdown could silently return wrong answers. Caller holds the
    shared lock (the fs method wraps this)."""
    from geomesa_tpu_torch import metrics

    st = store._types[type_name]
    ks = keyspace_for(st.sft, st.primary)
    errors: list = []

    def drift(pid, ci, msg):
        errors.append((pid, ci, msg))
        metrics.store_chunk_stat_drift.inc()

    for p in st.partitions:
        cs = p.chunks
        if cs is None:
            continue
        if cs.total_rows != int(p.count):
            drift(p.pid, -1, (
                f"chunk rows sum {cs.total_rows} != partition count "
                f"{int(p.count)}"
            ))
            continue
        if cs.nbytes is not None:
            from geomesa_tpu_torch.store.partfile import read_header

            blocks = read_header(store._part_path(type_name, p))["chunks"]
            if len(blocks) != len(cs):
                drift(p.pid, -1, (
                    f"{len(blocks)} chunk blocks != {len(cs)} chunks"
                ))
                continue
            for i, blk in enumerate(blocks):
                if int(blk["rows"]) != int(cs.rows[i]):
                    drift(p.pid, i, (
                        f"chunk block rows {int(blk['rows'])} != "
                        f"chunk rows {int(cs.rows[i])}"
                    ))
                if int(blk["length"]) != int(cs.nbytes[i]):
                    drift(p.pid, i, (
                        f"chunk block bytes {int(blk['length'])} != "
                        f"manifest {int(cs.nbytes[i])}"
                    ))
        batch = store._read_partition_unlocked(type_name, p, cache=False)
        if len(batch) != int(p.count):
            drift(p.pid, -1, (
                f"file rows {len(batch)} != partition count {int(p.count)}"
            ))
            continue
        keys = ks.index_keys(batch)
        key_cols = [keys[c] for c in ks.key_columns]
        geom = st.sft.geom_field
        dtg = st.sft.dtg_field
        xy = None
        if geom is not None and len(batch):
            col = batch.columns[geom]
            if col.dtype != object:
                xy = (col[:, 0], col[:, 1])
        for ci in range(len(cs)):
            s, e = int(cs.starts[ci]), int(cs.stops[ci])
            if e <= s:
                continue
            lo = cks._key_tuple(key_cols, s)
            hi = cks._key_tuple(key_cols, e - 1)
            if lo != tuple(cs.key_lo[ci]) or hi != tuple(cs.key_hi[ci]):
                drift(p.pid, ci, (
                    f"key span {lo}..{hi} != manifest "
                    f"{tuple(cs.key_lo[ci])}..{tuple(cs.key_hi[ci])}"
                ))
            if xy is not None and cs.bbox is not None:
                x, y = xy[0][s:e], xy[1][s:e]
                want = cs.bbox[ci]
                got = (x.min(), y.min(), x.max(), y.max())
                # equal_nan: a NaN-coordinate chunk legitimately records
                # a NaN bbox (classified BOUNDARY, never pruned away)
                if not np.allclose(got, want, equal_nan=True):
                    drift(p.pid, ci, f"bbox {got} != manifest {tuple(want)}")
                if len(cs.cells) > ci and len(cs.cells[ci]):
                    mass = int(cs.cell_counts[ci].sum())
                    if mass != e - s:
                        drift(p.pid, ci, (
                            f"density cell mass {mass} != chunk rows {e - s}"
                        ))
            if dtg is not None and cs.time_range is not None:
                d = np.asarray(batch.column(dtg))[s:e]
                t0, t1 = int(d.min()), int(d.max())
                if (t0, t1) != (
                    int(cs.time_range[ci][0]), int(cs.time_range[ci][1])
                ):
                    drift(p.pid, ci, (
                        f"time range ({t0}, {t1}) != manifest "
                        f"{tuple(int(v) for v in cs.time_range[ci])}"
                    ))
            for rec in cs.partials[ci]:
                col = np.asarray(batch.column(rec["attr"]))[s:e]
                if not (
                    np.isclose(float(col.min()), float(rec["min"]))
                    and np.isclose(float(col.max()), float(rec["max"]))
                ):
                    drift(p.pid, ci, (
                        f"minmax({rec['attr']}) "
                        f"({col.min()}, {col.max()}) != manifest "
                        f"({rec['min']}, {rec['max']})"
                    ))
    return errors
