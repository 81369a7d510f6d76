"""Chunked columnar partition statistics (partition format v2).

Copy of ``geomesa_tpu/store/chunkstats.py`` (ref role: the server-side
aggregation tier, geomesa-accumulo DensityIterator / StatsIterator,
rebuilt as write-time pre-aggregation). Every generation-scoped partition
file is split into fixed-size row chunks (``store.chunk.rows``), and the
manifest records per-chunk statistics:

- row count (``rows``),
- Z-order key min/max (``key_lo``/``key_hi``; the file is sorted by the
  primary key columns, so a chunk's first/last row IS its key extremum),
- bbox and time range,
- a sparse per-cell density histogram on a fixed world grid
  (``store.chunk.grid`` cells per dimension over lon/lat),
- stats-sketch partials (MinMax records parseable by ``stat_from_json``),
- the byte size of the chunk's block in the partition file (chunks align
  1:1 with the file's chunk blocks, ``store/partfile.py``, so a pruned
  read skips real file bytes).

The consumer is the aggregation pushdown (``store/pushdown.py``):
count/density/stats queries whose filter is a bbox+time conjunction
classify chunks as interior (answered from the manifest), boundary (read
and refined row by row through the runner) or disjoint (skipped).
``FileSystemDataStore.verify_chunk_stats`` cross-checks the records
against decoded rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: manifest format versions (``"format"`` manifest key; absent = v1)
FORMAT_V1 = 1
FORMAT_V2 = 2

#: world extents the coarse density grid quantizes (lon/lat degrees)
WORLD = (-180.0, -90.0, 180.0, 90.0)

#: chunk classification against aggregate bounds
DISJOINT, BOUNDARY, INTERIOR = 0, 1, 2


@dataclass
class ChunkSet:
    """Per-chunk statistics for ONE partition file (parallel arrays,
    one entry per chunk; chunk row offsets are partition-relative)."""

    starts: np.ndarray  # (m,) int64, starts[0] == 0
    stops: np.ndarray  # (m,) int64, stops[-1] == partition row count
    key_lo: list  # m key tuples (primary index key columns)
    key_hi: list
    grid: int  # density grid edge (grid x grid world cells)
    cells: list  # m int64 arrays: occupied world-grid cell ids
    cell_counts: list  # m int64 arrays, aligned with ``cells``
    partials: list  # m lists of stat-json dicts (minmax sketches)
    bbox: "np.ndarray | None" = None  # (m, 4) xmin ymin xmax ymax
    time_range: "np.ndarray | None" = None  # (m, 2) ms
    nbytes: "np.ndarray | None" = None  # (m,) encoded row-group bytes
    has_vis: bool = False  # any row carries a visibility label
    chunk_rows: int = 0  # the nominal chunk size this set was built at

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def rows(self) -> np.ndarray:
        return self.stops - self.starts

    @property
    def total_rows(self) -> int:
        return int(self.stops[-1]) if len(self.starts) else 0


def _key_tuple(key_cols, i: int) -> tuple:
    """Key tuple at sorted row ``i`` (numpy scalars -> python for exact
    lexicographic comparison against KeyRange tuples)."""
    out = []
    for c in key_cols:
        v = c[i]
        out.append(v.item() if isinstance(v, np.generic) else v)
    return tuple(out)


def world_cells(x: np.ndarray, y: np.ndarray, grid: int) -> np.ndarray:
    """World-grid cell id (iy * grid + ix) per point. Non-finite
    coordinates clamp deterministically to cell 0's axis (NaN.astype is
    undefined behavior); chunks holding such rows have a non-finite
    bbox, which classify()/density force down the row-refinement path,
    so the polluted cells are never SERVED — they only keep the
    build/fsck recomputation deterministic."""
    ix = np.clip(
        np.nan_to_num(
            (np.asarray(x, dtype=np.float64) - WORLD[0])
            / (WORLD[2] - WORLD[0])
            * grid
        ).astype(np.int64),
        0,
        grid - 1,
    )
    iy = np.clip(
        np.nan_to_num(
            (np.asarray(y, dtype=np.float64) - WORLD[1])
            / (WORLD[3] - WORLD[1])
            * grid
        ).astype(np.int64),
        0,
        grid - 1,
    )
    return iy * grid + ix


def _minmax_attrs(sft) -> list:
    """Attributes that get per-chunk MinMax partials: the same numeric/
    date set ``build_default_stats`` sketches, so chunk partials merge
    into the stats the planner and the stats API already speak."""
    return [
        a.name
        for a in sft.attributes
        if not a.is_geometry
        and a.column_dtype is not None
        and a.column_dtype != np.bool_
    ]


def build_chunk_set(
    keyspace,
    batch,
    keys: dict,
    start: int,
    stop: int,
    chunk_rows: int,
    grid: int,
) -> ChunkSet:
    """Chunk statistics for the ``[start, stop)`` partition slice of a
    SORTED built index (``batch``/``keys`` sorted by the key columns, so
    each chunk's first/last row is its lexicographic key min/max). One
    vectorized ``reduceat`` pass per statistic -- the same discipline as
    ``index.build.make_partitions``, one level finer."""
    sft = batch.sft
    n = stop - start
    starts = np.arange(0, max(n, 1), max(int(chunk_rows), 1), dtype=np.int64)
    starts = starts[starts < max(n, 1)]
    if n == 0:
        starts = np.array([0], dtype=np.int64)
        stops = np.array([0], dtype=np.int64)
    else:
        stops = np.minimum(starts + int(chunk_rows), n)
    key_cols = [keys[c] for c in keyspace.key_columns]
    key_lo = [_key_tuple(key_cols, start + int(s)) for s in starts] if n else [
        ()
    ]
    key_hi = [
        _key_tuple(key_cols, start + int(e) - 1) for e in stops
    ] if n else [()]

    geom = sft.geom_field
    dtg = sft.dtg_field
    abs_starts = starts + start
    bbox = None
    cells: list = [np.array([], dtype=np.int64)] * len(starts)
    cell_counts: list = [np.array([], dtype=np.int64)] * len(starts)
    if geom is not None and n:
        col = batch.columns[geom]
        if col.dtype != object:
            x = np.ascontiguousarray(col[start:stop, 0])
            y = np.ascontiguousarray(col[start:stop, 1])
            xmn, ymn = x, y
            xmx, ymx = x, y
            # density cells only for point schemas: the coarse histogram
            # counts point locations, which is what density() rasterizes
            cell = world_cells(x, y, grid)
            cells, cell_counts = [], []
            for s, e in zip(starts.tolist(), stops.tolist()):
                v, c = np.unique(cell[s:e], return_counts=True)
                cells.append(v.astype(np.int64))
                cell_counts.append(c.astype(np.int64))
        else:
            bb = batch.bboxes(geom)[start:stop]
            xmn, ymn = bb[:, 0], bb[:, 1]
            xmx, ymx = bb[:, 2], bb[:, 3]
        bbox = np.stack(
            [
                np.minimum.reduceat(xmn, starts),
                np.minimum.reduceat(ymn, starts),
                np.maximum.reduceat(xmx, starts),
                np.maximum.reduceat(ymx, starts),
            ],
            axis=1,
        ).astype(np.float64)
    time_range = None
    if dtg is not None and n:
        d = np.asarray(batch.column(dtg))[start:stop]
        time_range = np.stack(
            [np.minimum.reduceat(d, starts), np.maximum.reduceat(d, starts)],
            axis=1,
        ).astype(np.int64)

    partials: list = [[] for _ in starts]
    if n:
        for name in _minmax_attrs(sft):
            col = np.asarray(batch.column(name))[start:stop]
            mns = np.minimum.reduceat(col, starts)
            mxs = np.maximum.reduceat(col, starts)
            for i in range(len(starts)):
                partials[i].append(
                    {
                        "type": "minmax",
                        "attr": name,
                        "min": mns[i].item(),
                        "max": mxs[i].item(),
                        "count": int(stops[i] - starts[i]),
                    }
                )

    has_vis = False
    vis = batch.visibilities
    if vis is not None and n:
        sl = vis[start:stop]
        has_vis = bool(
            np.any(np.array([v is not None and str(v) != "" for v in sl]))
        )
    return ChunkSet(
        starts=starts,
        stops=stops,
        key_lo=key_lo,
        key_hi=key_hi,
        grid=int(grid),
        cells=cells,
        cell_counts=cell_counts,
        partials=partials,
        bbox=bbox,
        time_range=time_range,
        has_vis=has_vis,
        chunk_rows=int(chunk_rows),
    )


# -- manifest JSON round trip ------------------------------------------------


def chunkset_to_json(cs: "ChunkSet | None") -> "dict | None":
    if cs is None:
        return None
    return {
        "grid": cs.grid,
        "chunk_rows": cs.chunk_rows,
        "has_vis": cs.has_vis,
        "rows": cs.rows.tolist(),
        "key_lo": [list(t) for t in cs.key_lo],
        "key_hi": [list(t) for t in cs.key_hi],
        "bbox": cs.bbox.tolist() if cs.bbox is not None else None,
        "time_range": (
            cs.time_range.tolist() if cs.time_range is not None else None
        ),
        "nbytes": cs.nbytes.tolist() if cs.nbytes is not None else None,
        "cells": [c.tolist() for c in cs.cells],
        "cell_counts": [c.tolist() for c in cs.cell_counts],
        "partials": cs.partials,
    }


def chunkset_from_json(d: "dict | None") -> "ChunkSet | None":
    if not d:
        return None
    rows = np.asarray(d["rows"], dtype=np.int64)
    stops = np.cumsum(rows)
    starts = stops - rows
    return ChunkSet(
        starts=starts,
        stops=stops,
        key_lo=[tuple(t) for t in d["key_lo"]],
        key_hi=[tuple(t) for t in d["key_hi"]],
        grid=int(d.get("grid", 0)),
        cells=[np.asarray(c, dtype=np.int64) for c in d.get("cells", [])],
        cell_counts=[
            np.asarray(c, dtype=np.int64) for c in d.get("cell_counts", [])
        ],
        partials=d.get("partials", [[] for _ in rows]),
        bbox=(
            np.asarray(d["bbox"], dtype=np.float64)
            if d.get("bbox") is not None
            else None
        ),
        time_range=(
            np.asarray(d["time_range"], dtype=np.int64)
            if d.get("time_range") is not None
            else None
        ),
        nbytes=(
            np.asarray(d["nbytes"], dtype=np.int64)
            if d.get("nbytes") is not None
            else None
        ),
        has_vis=bool(d.get("has_vis", False)),
        chunk_rows=int(d.get("chunk_rows", 0)),
    )


# -- classification ----------------------------------------------------------


def classify(cs: ChunkSet, envs, ivals) -> np.ndarray:
    """Per-chunk classification against a CONJUNCTION of aggregate
    bounds (``QueryPlan.agg_bounds`` semantics): ``envs`` is a union of
    Envelopes or None (spatially unconstrained), ``ivals`` a union of
    inclusive ``(t0_ms, t1_ms)`` intervals or None. Returns INTERIOR
    (2: every row in the chunk satisfies the bounds -- its bbox sits
    inside a single envelope and its time range inside a single
    interval), DISJOINT (0: provably no row matches) or BOUNDARY (1).
    Chunks without a bbox/time record classify conservatively as
    BOUNDARY on that dimension."""
    m = len(cs)
    inside_g = np.ones(m, dtype=bool)
    meets_g = np.ones(m, dtype=bool)
    if envs is not None:
        if cs.bbox is None:
            inside_g[:] = False  # cannot prove containment
        else:
            b = cs.bbox
            inside_g[:] = False
            meets_g[:] = False
            for e in envs:
                inside_g |= (
                    (b[:, 0] >= e.xmin)
                    & (b[:, 2] <= e.xmax)
                    & (b[:, 1] >= e.ymin)
                    & (b[:, 3] <= e.ymax)
                )
                meets_g |= (
                    (b[:, 0] <= e.xmax)
                    & (b[:, 2] >= e.xmin)
                    & (b[:, 1] <= e.ymax)
                    & (b[:, 3] >= e.ymin)
                )
            # a NaN coordinate anywhere in the chunk poisons its bbox
            # (reduceat propagates NaN) and every NaN comparison above
            # is False — which would classify the chunk DISJOINT and
            # silently drop its VALID rows. Non-finite bboxes are
            # undecidable: always BOUNDARY (row-level refinement)
            bad = ~np.isfinite(b).all(axis=1)
            inside_g[bad] = False
            meets_g[bad] = True
    inside_t = np.ones(m, dtype=bool)
    meets_t = np.ones(m, dtype=bool)
    if ivals is not None:
        if cs.time_range is None:
            inside_t[:] = False
        else:
            t = cs.time_range
            inside_t[:] = False
            meets_t[:] = False
            for t0, t1 in ivals:
                inside_t |= (t[:, 0] >= t0) & (t[:, 1] <= t1)
                meets_t |= (t[:, 0] <= t1) & (t[:, 1] >= t0)
    out = np.full(m, BOUNDARY, dtype=np.int8)
    out[~(meets_g & meets_t)] = DISJOINT
    out[inside_g & inside_t & meets_g & meets_t] = INTERIOR
    return out


def chunks_overlapping(cs: ChunkSet, ranges) -> np.ndarray:
    """Bool mask of chunks whose key span overlaps ANY planned KeyRange
    (the partition-level ``PartitionMeta.overlaps`` test, one level
    finer). Sound the same way partition pruning is: the planner's
    ranges cover every key a filter-matching row can have, so a chunk
    overlapping none contains no matching rows.

    Ranges are sorted by ``lo`` but may nest/overlap, so per chunk we
    bisect to the last range starting at-or-below the chunk's key_hi
    and test the PREFIX MAXIMUM of range highs against key_lo -- exact,
    O((chunks + ranges) log ranges)."""
    from bisect import bisect_right

    m = len(cs)
    if not ranges:
        return np.zeros(m, dtype=bool)
    rs = sorted(ranges, key=lambda r: r.lo)
    los = [r.lo for r in rs]
    max_hi: list = []
    cur = None
    for r in rs:
        cur = r.hi if cur is None or r.hi > cur else cur
        max_hi.append(cur)
    out = np.zeros(m, dtype=bool)
    for i in range(m):
        j = bisect_right(los, cs.key_hi[i])
        if j > 0 and max_hi[j - 1] >= cs.key_lo[i]:
            out[i] = True
    return out


# -- density proration -------------------------------------------------------


def _overlap_matrix(
    grid: int, lo: float, hi: float, q0: float, q1: float, pixels: int
) -> np.ndarray:
    """(grid, pixels) fraction-of-cell matrix along one axis: entry
    ``[c, p]`` is (cell c ∩ pixel p) / cell width."""
    cw = (hi - lo) / grid
    pw = (q1 - q0) / pixels
    c0 = lo + np.arange(grid, dtype=np.float64)[:, None] * cw
    p0 = q0 + np.arange(pixels, dtype=np.float64)[None, :] * pw
    ov = np.minimum(c0 + cw, p0 + pw) - np.maximum(c0, p0)
    return np.clip(ov, 0.0, None) / cw


def prorate_coarse(
    coarse: np.ndarray,
    grid: int,
    env,
    width: int,
    height: int,
) -> np.ndarray:
    """Distribute a (grid, grid) world-cell count matrix onto a query
    raster by area overlap (uniform-within-cell assumption -- the
    chunk-granularity tolerance the pushdown contract documents). A
    cell's mass outside the raster drops proportionally, matching the
    row scan's inside-the-viewport test to within cell granularity."""
    wx = _overlap_matrix(grid, WORLD[0], WORLD[2], env.xmin, env.xmax, width)
    wy = _overlap_matrix(grid, WORLD[1], WORLD[3], env.ymin, env.ymax, height)
    return (wy.T @ coarse @ wx).astype(np.float32)
