"""Spatial-join planner: Z-range co-partitioned candidate runs with
adaptive strategy selection.

Copy of ``geomesa_tpu/join/planner.py`` without ``clip_runs_to_shards``
(the mesh's co-partitioning, ROADMAP item 7). The planner turns (a
Z-sorted left layout, m right-side envelope windows) into candidate RUNS
-- contiguous row ranges of the sorted layout, window-major -- that the
refinement (``ops/join.py``) expands and tests in batches. Three
strategies, selected from a 2^h x 2^h world-grid histogram of the left
side built once per staged generation:

- ``broadcast``: the right side is tiny, so every window scans the whole
  left side (one run per window);
- ``grouped``: per-window scans over COARSE Z-cells (the histogram level):
  few, long runs, for windows large relative to cells;
- ``zmerge``: a sorted Z-interval merge at an adaptively chosen deeper
  level: each window decomposes into merged Z-ranges whose row runs come
  from one ``searchsorted`` against the sorted keys. Cells STRICTLY inside
  a window's covering ring are flagged INTERIOR in integer cell space (an
  exact argument on the quantized key), so their candidates skip the
  coordinate test.

A skew-splitting escape bounds every run at ``join.split.rows`` rows, so
a hot cell cannot blow one batch's candidate budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.xz import norm01

#: relative planning cost of touching one cell vs testing one candidate
#: (fitted on the CPU harness: ~0.25us/cell of decomposition work vs
#: ~0.1us/candidate of expand+refine; the ratio, not the absolute scale,
#: drives the level choice and is stable across machines)
_CELL_COST = 2.5

#: deepest decomposition level the adaptive search considers (cells of
#: ~1e-5 deg; beyond this the per-window cell counts explode long before
#: candidate sets tighten further)
_MAX_LEVEL = 15

_BITS = 31  # z2 bits per dimension


@dataclass
class JoinStats:
    """Selectivity/skew estimates the strategy choice was made from."""

    n_left: int = 0
    n_right: int = 0
    est_candidates: float = 0.0
    est_pairs: float = 0.0
    selectivity: float = 0.0
    skew: float = 0.0

    def to_json(self) -> dict:
        return {
            "n_left": self.n_left,
            "n_right": self.n_right,
            "est_candidates": round(self.est_candidates, 1),
            "est_pairs": round(self.est_pairs, 1),
            "selectivity": round(self.selectivity, 8),
            "skew": round(self.skew, 2),
        }


@dataclass
class JoinPlan:
    """Candidate runs + the decisions that produced them. Runs are
    window-major with ascending rows inside each window — the engine's
    emission order needs no sort when the layout permutation is
    monotonic."""

    strategy: str                  # broadcast | grouped | zmerge
    level: int                     # decomposition level (0 = broadcast)
    starts: np.ndarray             # (R,) run start rows (sorted layout)
    ends: np.ndarray               # (R,) run end rows (exclusive)
    wins: np.ndarray               # (R,) window of each run
    interior: np.ndarray           # (R,) run needs no coordinate test
    stats: JoinStats = field(default_factory=JoinStats)
    splits: int = 0                # runs added by the skew-split escape
    forced: bool = False           # strategy pinned by join.strategy

    @property
    def n_runs(self) -> int:
        return len(self.starts)

    @property
    def candidates(self) -> int:
        return int((self.ends - self.starts).sum()) if len(self.starts) else 0


def clip_envs(envs: np.ndarray) -> np.ndarray:
    """Clamp window envelopes to world bounds (the key space); inverted
    envelopes stay inverted (they match nothing)."""
    out = np.array(envs, np.float64, copy=True).reshape(-1, 4)
    out[:, 0] = np.clip(out[:, 0], -180.0, 180.0)
    out[:, 2] = np.clip(out[:, 2], -180.0, 180.0)
    out[:, 1] = np.clip(out[:, 1], -90.0, 90.0)
    out[:, 3] = np.clip(out[:, 3], -90.0, 90.0)
    return out


def _argsort_u64(comp):
    """Stable argsort of non-negative 64-bit keys: numpy's for a host array
    (the counterpart's native radix sort returns the same order), or
    ``torch.sort(stable=True)`` for an int64 tensor, on its device. Z2 keys
    (62 bits), XZ2 codes and the planner's window-major cell keys all fit
    int64 without the sign bit, so the signed sort is the unsigned one."""
    if isinstance(comp, torch.Tensor):
        return torch.sort(comp, stable=True).indices
    return np.argsort(comp, kind="stable")


def _cell_runs(keys, lon, lat, envs, level: int):
    """Candidate runs for ``envs`` at one decomposition ``level``: every
    window's covering Z-cells, interior-flagged in integer cell space,
    Z-adjacent cells merged, then one vectorized searchsorted against
    the sorted keys. Returns (starts, ends, wins, interior)."""
    m = len(envs)
    e = np.empty((0,), np.int64)
    if m == 0 or len(keys) == 0:
        return e, e.copy(), e.copy(), np.empty(0, bool)
    s = _BITS - level
    nx0 = np.asarray(lon.normalize(envs[:, 0]), np.int64) >> s
    nx1 = np.asarray(lon.normalize(envs[:, 2]), np.int64) >> s
    ny0 = np.asarray(lat.normalize(envs[:, 1]), np.int64) >> s
    ny1 = np.asarray(lat.normalize(envs[:, 3]), np.int64) >> s
    # inverted (empty) windows cover no cells
    ncx = np.maximum(nx1 - nx0 + 1, 0)
    ncy = np.maximum(ny1 - ny0 + 1, 0)
    ncells = ncx * ncy
    tot = int(ncells.sum())
    if tot == 0:
        return e, e.copy(), e.copy(), np.empty(0, bool)
    cwin = np.repeat(np.arange(m, dtype=np.int64), ncells)
    ofs = np.concatenate([[0], np.cumsum(ncells)[:-1]])
    k = np.arange(tot, dtype=np.int64) - np.repeat(ofs, ncells)
    cxw = np.repeat(np.maximum(ncx, 1), ncells)
    cx = np.repeat(nx0, ncells) + (k % cxw)
    cy = np.repeat(ny0, ncells) + (k // cxw)
    cz = zorder.encode_2d_np(cx.astype(np.uint64), cy.astype(np.uint64))
    # window-major, Z-ascending cell order (the emission order contract)
    comp = (cwin.astype(np.uint64) << np.uint64(2 * level)) | cz
    so = _argsort_u64(comp)
    cwin, cx, cy, cz = cwin[so], cx[so], cy[so], cz[so]
    # interior = strictly inside the covering ring IN CELL SPACE: any
    # point in such a cell quantizes strictly between the window
    # boundaries' cells, and the normalizer is monotone, so the point's
    # coordinates are inside the window — exact, no float reconstruction
    interior = (
        (cx > nx0[cwin]) & (cx < nx1[cwin])
        & (cy > ny0[cwin]) & (cy < ny1[cwin])
    )
    # merge Z-adjacent cells of one window sharing the interior flag
    new = np.ones(tot, bool)
    if tot > 1:
        new[1:] = (
            (cwin[1:] != cwin[:-1])
            | (cz[1:] != cz[:-1] + np.uint64(1))
            | (interior[1:] != interior[:-1])
        )
    nz = np.nonzero(new)[0]
    last = np.concatenate([nz[1:] - 1, [tot - 1]])
    shift = np.uint64(2 * s)
    run_lo = cz[nz] << shift
    run_hi = (cz[last] + np.uint64(1)) << shift
    starts = np.searchsorted(keys, run_lo).astype(np.int64)
    ends = np.searchsorted(keys, run_hi).astype(np.int64)
    return starts, ends, cwin[nz], interior[nz]


def _xz_point_codes(sfc, px, py):
    """(window, code) pairs of every XZ2 cell whose enlarged extent holds
    the point (px[j], py[j]): the cells a point window's XZ walk matches,
    at every level (a point contains no enlarged cell, so the walk never
    emits a whole subtree for one but refines to level g, where the
    budget allows). Vectorized over the points: at level l the cell
    columns k with k * 2^-l <= p <= k * 2^-l + 2 * 2^-l are floor(p 2^l)
    and the one or two before it, the same dyadic compares the walk makes.
    Since an element is stored at the cell that holds its lower-left
    corner and lies inside that cell's enlarged extent, every element
    that overlaps the point has one of these codes."""
    xz = sfc._xz
    nx = norm01(px, sfc.x_lo, sfc.x_hi)
    ny = norm01(py, sfc.y_lo, sfc.y_hi)
    steps = [xz._child_step(i) for i in range(xz.g)]
    wins, codes = [], []
    idx = np.arange(len(nx), dtype=np.int64)
    for lv in range(xz.g + 1):
        side = 1 << lv
        w = 0.5**lv
        cols = []
        for v in (nx, ny):
            k0 = np.floor(v * side).astype(np.int64)
            ks = []
            for k in (k0 - 2, k0 - 1, k0):
                lo = k * w
                ks.append((k, (k >= 0) & (k < side) & (lo <= v) & (v <= lo + 2 * w)))
            cols.append(ks)
        for kx, okx in cols[0]:
            for ky, oky in cols[1]:
                ok = okx & oky
                if not ok.any():
                    continue
                cx, cy, j = kx[ok], ky[ok], idx[ok]
                code = np.full(len(j), lv, np.int64)
                for i in range(lv):
                    bit = lv - 1 - i
                    quad = ((cx >> bit) & 1) | (((cy >> bit) & 1) << 1)
                    code += quad * steps[i]
                wins.append(j)
                codes.append(code)
    if not wins:
        e = np.empty(0, np.int64)
        return e, e.copy()
    return np.concatenate(wins), np.concatenate(codes)


def _xz_runs(keys, sfc, envs, max_ranges: int):
    """Candidate runs for a non-point (XZ2) layout: per-window XZ code
    ranges (the durable index's query decomposition) merged against the
    sorted extent-curve keys. XZ candidates are envelope-overlap
    candidates — never interior — so every emitted pair still passes
    the envelope-overlap refinement.

    Where the port differs: a window that is a point (the push tier's
    feature points against the subscription layout) takes the vectorized
    cover of ``_xz_point_codes``, one code a run; the counterpart walks
    each window in Python (its native library does it in C++), and the
    walk of a point takes about a millisecond here. Both covers hold
    every overlapping element, so the refined pairs are the same."""
    los: list = []
    his: list = []
    wins: list = []
    point = (envs[:, 0] == envs[:, 2]) & (envs[:, 1] == envs[:, 3])
    for j in np.nonzero(~point)[0]:
        a, b, c, d = envs[j]
        if a > c or b > d:
            continue
        for r in sfc.ranges(a, b, c, d, max_ranges=max_ranges):
            los.append(r.lower)
            his.append(r.upper + 1)  # inclusive code range -> exclusive
            wins.append(j)
    starts = np.searchsorted(keys, np.asarray(los, np.uint64)).astype(np.int64)
    ends = np.searchsorted(keys, np.asarray(his, np.uint64)).astype(np.int64)
    win = np.asarray(wins, np.int64)
    pj = np.nonzero(point)[0]
    if len(pj) and len(keys):
        pw, pc = _xz_point_codes(sfc, envs[pj, 0], envs[pj, 1])
        # a point's cells that hold no element carry no candidate: drop them
        # first (a lookup table over the keys' code span when it is small,
        # as for the default precision's 22M codes)
        span = int(keys[-1]) - int(keys[0])
        hit = np.isin(pc, keys.astype(np.int64), kind="table" if span < (1 << 26) else None)
        pw, pc = pw[hit], pc[hit].astype(np.uint64)
        starts = np.concatenate([starts, np.searchsorted(keys, pc).astype(np.int64)])
        ends = np.concatenate([ends, np.searchsorted(keys, pc + np.uint64(1)).astype(np.int64)])
        win = np.concatenate([win, pj[pw]])
        order = np.lexsort((starts, win))  # window-major, codes ascending
        starts, ends, win = starts[order], ends[order], win[order]
    return starts, ends, win, np.zeros(len(starts), bool)


def _broadcast_runs(n: int, m: int):
    """One whole-side run per window — no partitioning, the batched
    kernel chunks the n x m candidate space by its launch budget."""
    starts = np.zeros(m, np.int64)
    ends = np.full(m, n, np.int64)
    wins = np.arange(m, dtype=np.int64)
    return starts, ends, wins, np.zeros(m, bool)


def split_runs(starts, ends, wins, interior, cap: int):
    """Skew-split escape: bound every run at ``cap`` rows. A hot cell
    (adversarial all-in-one-cell layouts, GDELT city clusters) otherwise
    produces one run whose candidate count blows the launch budget and
    unbalances co-partitioned shards. Splitting preserves order (the
    sub-runs of a run stay adjacent and ascending). Returns the new runs
    plus how many extra runs the split introduced."""
    lens = ends - starts
    nseg = np.maximum(-(-lens // cap), 1)
    extra = int(nseg.sum()) - len(starts)
    if extra == 0:
        return (starts, ends, wins, interior), 0
    tot = int(nseg.sum())
    rep_start = np.repeat(starts, nseg)
    ofs = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    seg = np.arange(tot, dtype=np.int64) - np.repeat(ofs, nseg)
    sub_start = rep_start + seg * cap
    sub_end = np.minimum(sub_start + cap, np.repeat(ends, nseg))
    return (
        sub_start, sub_end, np.repeat(wins, nseg), np.repeat(interior, nseg),
    ), extra


def _window_estimates(hist_prefix, hbits: int, lon, lat, envs):
    """Per-window left-row estimates from the staged histogram: a 2-D
    prefix sum turns each window's covered coarse-cell rectangle into
    four lookups."""
    m = len(envs)
    if m == 0:
        return np.zeros(0, np.float64)
    s = _BITS - hbits
    cx0 = np.asarray(lon.normalize(envs[:, 0]), np.int64) >> s
    cx1 = np.asarray(lon.normalize(envs[:, 2]), np.int64) >> s
    cy0 = np.asarray(lat.normalize(envs[:, 1]), np.int64) >> s
    cy1 = np.asarray(lat.normalize(envs[:, 3]), np.int64) >> s
    S = hist_prefix
    est = (
        S[cy1 + 1, cx1 + 1] - S[cy0, cx1 + 1]
        - S[cy1 + 1, cx0] + S[cy0, cx0]
    ).astype(np.float64)
    return np.maximum(est, 0.0)


def plan_join(jidx, envs: np.ndarray, conf: dict) -> JoinPlan:
    """Build the candidate-run plan for ``envs`` over a prepared join
    layout (:class:`geomesa_tpu_torch.join.engine.JoinIndex`). ``conf`` holds
    the resolved ``join.*`` properties (see conf.py)."""
    envs = clip_envs(envs)
    m = len(envs)
    n = jidx.n
    forced = conf["strategy"] != "auto"
    strategy = conf["strategy"]
    level = 0
    stats = JoinStats(n_left=n, n_right=m)

    hbits = jidx.hist_bits
    est_w = None
    if jidx.hist_prefix is not None and m:
        est_w = _window_estimates(
            jidx.hist_prefix, hbits, jidx.lon, jidx.lat, envs
        )
        wx = np.maximum(envs[:, 2] - envs[:, 0], 0.0)
        wy = np.maximum(envs[:, 3] - envs[:, 1], 0.0)
        ch_w = 360.0 / (1 << hbits)
        ch_h = 180.0 / (1 << hbits)
        # density per window from the coarse covered area; pairs estimate
        # scales it back down to the window's true area
        cov = np.maximum(wx + ch_w, ch_w) * np.maximum(wy + ch_h, ch_h)
        dens = est_w / cov
        est_pairs = float((dens * wx * wy).sum())
        stats.est_pairs = est_pairs
        stats.selectivity = est_pairs / max(n * m, 1)
        mean_w = float(est_w.mean()) if m else 0.0
        stats.skew = float(est_w.max() / mean_w) if mean_w > 0 else 0.0

    if strategy == "auto":
        if m <= conf["broadcast_windows"] or n <= 1024 or est_w is None:
            strategy = "broadcast"
        else:
            strategy = "zmerge"  # level search below decides grouped

    if strategy == "broadcast" or jidx.kind is None:
        runs = _broadcast_runs(n, m)
        stats.est_candidates = float(n) * m
        plan = JoinPlan("broadcast", 0, *runs, stats=stats, forced=forced)
    elif jidx.kind == "xz2":
        runs = _xz_runs(jidx.keys, jidx.sfc, envs, conf["xz_ranges"])
        strategy = "zmerge" if strategy == "auto" else strategy
        plan = JoinPlan("zmerge", 0, *runs, stats=stats, forced=forced)
        plan.stats.est_candidates = float(plan.candidates)
    else:
        # adaptive level: analytic cost over candidate levels — cells
        # shrink candidates toward the true pairs but add planning work
        if strategy == "grouped" or est_w is None:
            level = hbits
            strategy = "grouped" if not forced else strategy
        else:
            wx = np.maximum(envs[:, 2] - envs[:, 0], 0.0)
            wy = np.maximum(envs[:, 3] - envs[:, 1], 0.0)
            best_cost, best_level = None, hbits
            for cand in range(4, _MAX_LEVEL + 1):
                cw = 360.0 / (1 << cand)
                ch = 180.0 / (1 << cand)
                cells = ((wx / cw + 1.0) * (wy / ch + 1.0)).sum()
                cand_c = (dens * (wx + cw) * (wy + ch)).sum()
                cost = _CELL_COST * cells + cand_c
                if best_cost is None or cost < best_cost:
                    best_cost, best_level = cost, cand
            level = best_level
            if not forced:
                strategy = "grouped" if level <= hbits else "zmerge"
            if strategy == "grouped":
                level = min(level, hbits)
        runs = _cell_runs(jidx.keys, jidx.lon, jidx.lat, envs, level)
        plan = JoinPlan(strategy, level, *runs, stats=stats, forced=forced)
        plan.stats.est_candidates = float(plan.candidates)

    (plan.starts, plan.ends, plan.wins, plan.interior), plan.splits = (
        split_runs(
            plan.starts, plan.ends, plan.wins, plan.interior,
            conf["split_rows"],
        )
    )
    return plan
