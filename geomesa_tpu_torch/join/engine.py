"""Spatial join engine: prepared Z-sorted join layouts, adaptive planning,
and batched count -> compact refinement.

Copy of ``geomesa_tpu/join/engine.py``. The engine joins a LEFT side (a
resident :class:`DeviceIndex`'s host mirror, or any FeatureBatch) against
m right-side envelope windows and returns exact envelope-join pairs: for
point layouts the point lies inside the window (inclusive, float64), for
non-point layouts the row's envelope overlaps it (the coarse pass of a
topological join, which ``process/join.py`` refines with the exact
predicate).

Layout: the engine keeps its own spatial key layout per staged generation
(``JoinIndex``): Z2 Morton keys for point schemas, XZ2 extent codes for
non-point ones. Rows already in key order keep the identity permutation;
any other order is sorted once at prepare. For a layout on the card the
keys are encoded, sorted (``torch.sort(stable=True)``) and the planes
gathered there, and the float64 planes stay resident; the host keeps the
sorted keys (the planner's ``searchsorted``) and the permutation.

Execution engines (``join.engine`` = auto | device | host):

- ``device``: run batches (``join.batch.candidates`` candidates each)
  expand and refine as torch ops on the layout's device (``ops/join.py``),
  a count pass then a compaction; pairs stay on the device until the end,
  where they map to original rows and sort to (window, row) order.
- ``host``: the numpy twin, the bit-identical oracle.

``auto`` resolves by the layout's device: ``device`` on the card, ``host``
for a layout on the CPU (the counterpart's all-CPU rule, read off the
tensor's device). The H100 has float64, so the device planes and the
envelopes always stage as float64: the counterpart's float32 fallback and
its exactness re-test (``_post_exact``) have no place here. Refinement
batches ride the scheduler's batch lane when one is supplied. A ``mesh``
raises: the co-partitioned mesh join waits for the mesh (ROADMAP item 7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.conf import sys_prop
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.normalize import NormalizedLat, NormalizedLon
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.join import planner as jp
from geomesa_tpu_torch.ops import join as jops

_CPU = torch.device("cpu")


def _join_conf() -> dict:
    return {
        "engine": sys_prop("join.engine"),
        "strategy": sys_prop("join.strategy"),
        "broadcast_windows": int(sys_prop("join.broadcast.windows")),
        "split_rows": max(int(sys_prop("join.split.rows")), 1024),
        "batch_candidates": max(int(sys_prop("join.batch.candidates")), 4096),
        "hist_bits": min(max(int(sys_prop("join.hist.bits")), 4), 10),
        "xz_ranges": max(int(sys_prop("join.xz.ranges")), 4),
    }


class JoinIndex:
    """Per-generation join layout over one left side: sorted spatial keys
    (host uint64), the sort permutation (None when the rows were already
    key-sorted), the sorted float64 coordinate planes, and the coarse
    world-grid histogram's prefix sums the planner estimates from. On a
    card the planes (and the permutation) also live on ``device``."""

    def __init__(self, kind, sfc, keys, perm, planes, lon, lat, hist_prefix, hist_bits,
                 gen=0, device=_CPU, dev_planes=None, dev_perm=None):
        self.kind = kind          # "z2" | "xz2"
        self.sfc = sfc
        self.keys = keys          # sorted uint64 codes
        self.perm = perm          # sorted row -> original row, or None
        self.planes = planes      # sorted host planes (x, y | x0, y0, x1, y1)
        self.lon = lon
        self.lat = lat
        self.hist_prefix = hist_prefix
        self.hist_bits = hist_bits
        self.gen = gen
        self.device = torch.device(device)
        self._dev = dev_planes
        self._perm_dev = dev_perm

    @property
    def n(self) -> int:
        return int(len(self.keys))

    @property
    def point(self) -> bool:
        return self.kind == "z2"

    def to_orig(self, rows: np.ndarray) -> np.ndarray:
        return rows if self.perm is None else self.perm[rows]

    def sort_gate(self, gate):
        """Original-row bool gate -> sorted-layout order."""
        if gate is None:
            return None
        return gate if self.perm is None else gate[self.perm]

    def device_planes(self) -> dict:
        """The sorted float64 planes on the layout's device, staged once."""
        if self._dev is None:
            self._dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                         for k, v in self.planes.items()}
        return self._dev

    def device_perm(self) -> "torch.Tensor | None":
        """The permutation on the layout's device (None: identity)."""
        if self.perm is None:
            return None
        if self._perm_dev is None:
            self._perm_dev = torch.from_numpy(self.perm).to(self.device)
        return self._perm_dev


@dataclass
class JoinResult:
    """Exact envelope-join pairs plus the execution report."""

    rows: np.ndarray              # left row ids (original layout order)
    wins: np.ndarray              # right window ids, pair-aligned
    strategy: str = "broadcast"
    level: int = 0
    engine: str = "host"
    launches: int = 0
    candidates: int = 0
    splits: int = 0
    shards: int = 0
    plan_s: float = 0.0
    refine_s: float = 0.0
    stats: "jp.JoinStats | None" = None

    @property
    def pairs(self) -> int:
        return len(self.rows)

    def report(self) -> dict:
        return {
            "strategy": self.strategy,
            "level": self.level,
            "engine": self.engine,
            "pairs": self.pairs,
            "candidates": self.candidates,
            "launches": self.launches,
            "skew_splits": self.splits,
            "shards": self.shards,
            "plan_s": round(self.plan_s, 4),
            "refine_s": round(self.refine_s, 4),
            "stats": self.stats.to_json() if self.stats else None,
        }


def _empty_result(**kw) -> JoinResult:
    e = np.empty(0, np.int64)
    return JoinResult(e, e.copy(), **kw)


def _layout(kind, sfc, planes: dict, lon, lat, hist_bits: int, gen: int, device) -> JoinIndex:
    """Keys, sort and histogram of one left side's float64 host planes: in
    numpy for a CPU layout (the counterpart's code), as torch ops for one
    on a card (keys encoded in float64 by the card encode, bit for bit the
    host ``sfc.index``; a stable sort; the planes gathered there)."""
    names = ("x", "y") if kind == "z2" else ("x0", "y0", "x1", "y1")
    n = len(planes[names[0]])
    s = jp._BITS - hist_bits
    side = 1 << hist_bits
    if device.type == "cpu":
        if kind == "z2":
            keys = np.asarray(sfc.index(planes["x"], planes["y"]), np.uint64) if n else (
                np.empty(0, np.uint64))
            hx, hy = planes["x"], planes["y"]
        else:
            keys = np.asarray(sfc.index(*(planes[k] for k in names)), np.uint64) if n else (
                np.empty(0, np.uint64))
            hx = (planes["x0"] + planes["x1"]) * 0.5
            hy = (planes["y0"] + planes["y1"]) * 0.5
        perm = None
        if n > 1 and not bool(np.all(keys[1:] >= keys[:-1])):
            perm = jp._argsort_u64(keys)
            keys = keys[perm]
            planes = {k: v[perm] for k, v in planes.items()}
        hist = None
        if n:
            cx = np.asarray(lon.normalize(hx), np.int64) >> s
            cy = np.asarray(lat.normalize(hy), np.int64) >> s
            hist = np.bincount((cy << hist_bits) | cx, minlength=side * side)
        return JoinIndex(kind, sfc, keys, perm, planes, lon, lat, _prefix(hist, side), hist_bits,
                         gen=gen)
    if kind == "xz2" and n and bool(np.any((planes["x1"] < planes["x0"])
                                          | (planes["y1"] < planes["y0"]))):
        raise ValueError("inverted box bounds (min > max); split antimeridian-crossing "
                         "geometries before indexing")
    tp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in planes.items()}
    if kind == "z2":
        keys_t = zorder._key_t(*sfc.index_hi_lo(tp["x"], tp["y"]))
        hx, hy = tp["x"], tp["y"]
    else:
        keys_t = zorder._key_t(*sfc.index_hi_lo(*(tp[k] for k in names)))
        hx, hy = (tp["x0"] + tp["x1"]) * 0.5, (tp["y0"] + tp["y1"]) * 0.5
    hist = None
    if n:
        cx = lon.normalize_t(hx).to(torch.int64) >> s
        cy = lat.normalize_t(hy).to(torch.int64) >> s
        hist = torch.bincount((cy << hist_bits) | cx, minlength=side * side).cpu().numpy()
    del hx, hy
    perm_t = None
    if n > 1 and not bool((keys_t[1:] >= keys_t[:-1]).all()):
        perm_t = jp._argsort_u64(keys_t)
        keys_t = keys_t[perm_t]
        tp = {k: v[perm_t] for k, v in tp.items()}
    keys = keys_t.cpu().numpy().view(np.uint64)
    del keys_t
    perm = None if perm_t is None else perm_t.cpu().numpy()
    host = {k: v.cpu().numpy() for k, v in tp.items()}
    return JoinIndex(kind, sfc, keys, perm, host, lon, lat, _prefix(hist, side), hist_bits,
                     gen=gen, device=device, dev_planes=tp, dev_perm=perm_t)


def _prefix(hist, side: int):
    """2-D prefix sums (side + 1, side + 1) of a flat (cy, cx) histogram."""
    if hist is None:
        return None
    S = np.zeros((side + 1, side + 1), np.int64)
    S[1:, 1:] = np.asarray(hist, np.int64).reshape(side, side).cumsum(0).cumsum(1)
    return S


def build_join_index(batch, sft, hist_bits: int, gen: int = 0, device=None) -> JoinIndex:
    """The join layout of one left side: spatial keys, sort permutation
    (None when the rows already arrive key-sorted), the sorted coordinate
    planes and the coarse histogram. ``device`` None: a host layout."""
    geom = sft.geom_field
    if geom is None:
        raise ValueError(f"spatial join needs a geometry field on {sft.type_name!r}")
    dev = _CPU if device is None else torch.device(device)
    n = len(batch)
    if sft.descriptor(geom).is_point:
        sfc = Z2SFC()
        x, y = batch.point_coords(geom)
        planes = {"x": np.asarray(x, np.float64), "y": np.asarray(y, np.float64)}
        return _layout("z2", sfc, planes, sfc.lon, sfc.lat, hist_bits, gen, dev)
    bb = batch.bboxes(geom) if n else np.zeros((0, 4))
    return _envelope_layout(bb, sft.xz_precision, hist_bits, gen, dev)


def _envelope_layout(bb, precision, hist_bits, gen, dev) -> JoinIndex:
    planes = {k: np.asarray(bb[:, i], np.float64) for i, k in enumerate(("x0", "y0", "x1", "y1"))}
    return _layout("xz2", XZ2SFC(precision), planes, NormalizedLon(jp._BITS),
                   NormalizedLat(jp._BITS), hist_bits, gen, dev)


def build_envelope_layout(envs, hist_bits: "int | None" = None, precision: int = 12,
                          gen: int = 0, device=None) -> JoinIndex:
    """XZ-encode raw ``(n, 4)`` [xmin, ymin, xmax, ymax] envelopes into a
    join layout with no FeatureBatch behind them (the continuous-query
    registry's geofences, encoded once and joined by every batch:
    ``JoinEngine(jidx=...)``). ``device`` None: a host layout."""
    if hist_bits is None:
        hist_bits = _join_conf()["hist_bits"]
    bb = np.asarray(envs, np.float64).reshape(-1, 4)
    return _envelope_layout(bb, precision, hist_bits, gen,
                            _CPU if device is None else torch.device(device))


class JoinEngine:
    """One joinable left side. Construct over a resident index (the layout
    caches on it per staged generation and lives on its device), a raw
    FeatureBatch (``device`` None: the card) or a prebuilt layout.

    >>> eng = JoinEngine(di)
    >>> res = eng.join(envs)           # exact envelope-join pairs
    >>> res.rows, res.wins, res.report()
    """

    def __init__(self, di=None, batch=None, sft=None, sched=None, mesh=None, jidx=None,
                 device=None):
        if di is None and batch is None and jidx is None:
            raise ValueError("JoinEngine needs a DeviceIndex, a batch or a prebuilt JoinIndex")
        if mesh is not None:
            raise NotImplementedError(
                "the co-partitioned mesh join (_execute_mesh) is not in the port yet: "
                "ROADMAP, port queue item 7, the mesh")
        self.di = di
        self._batch = batch
        self._sft = sft if sft is not None else (di.sft if di is not None else None)
        self.sched = sched
        #: a prebuilt layout (``build_envelope_layout``)
        self._own_jidx = jidx
        if di is not None:
            self.device = di.device
        elif jidx is not None and device is None:
            self.device = jidx.device
        else:
            self.device = resolve_device(device)

    # -- layout ------------------------------------------------------------

    def prepare(self, conf=None) -> JoinIndex:
        """Build (or fetch the cached) join layout for the current staged
        generation."""
        conf = conf or _join_conf()
        if self.di is not None:
            gen = self.di._gen
            cached = self.di._join_index
            if cached is not None and cached.gen == gen:
                return cached
            self.di._join_index = None  # free the old layout's planes first
            jidx = build_join_index(self.di._host_rows(), self._sft, conf["hist_bits"], gen=gen,
                                    device=self.device)
            self.di._join_index = jidx
            return jidx
        if self._own_jidx is None:
            self._own_jidx = build_join_index(self._batch, self._sft, conf["hist_bits"],
                                              device=self.device)
        return self._own_jidx

    # -- join --------------------------------------------------------------

    def join(self, envs, gate=None) -> JoinResult:
        """Exact envelope join of the left side against ``envs`` ((m, 4)
        [xmin, ymin, xmax, ymax]). ``gate`` is an optional bool mask over
        the left rows (base filter, visibility, validity) ANDed into every
        pair; a resident index's validity plane and fail-closed visibility
        verdict join it by themselves. Pairs come back sorted (window,
        row)."""
        from geomesa_tpu_torch import ledger, metrics
        from geomesa_tpu_torch.tracing import span

        conf = _join_conf()
        envs = np.asarray(envs, np.float64).reshape(-1, 4)
        m = len(envs)
        jidx = self.prepare(conf)
        if jidx.n == 0 or m == 0:
            return _empty_result(strategy="broadcast", engine="none")
        auto = _di_gate(self.di, jidx.n) if self.di is not None else None
        if auto is not None:
            gate = auto if gate is None else (gate & auto)
        t0 = time.perf_counter()
        with span("join.plan", windows=m, rows=jidx.n, kind=jidx.kind) as sp:
            plan = jp.plan_join(jidx, envs, conf)
            sp.set(
                strategy=plan.strategy, level=plan.level, runs=plan.n_runs, splits=plan.splits,
                est_candidates=plan.stats.est_candidates, est_pairs=plan.stats.est_pairs,
                skew=round(plan.stats.skew, 2),
            )
        plan_s = time.perf_counter() - t0
        engine = conf["engine"]
        if engine == "auto":
            engine = "device" if jidx.device.type == "cuda" else "host"
        t1 = time.perf_counter()
        with span("join.refine", engine=engine, strategy=plan.strategy, runs=plan.n_runs) as sp:
            if engine == "device":
                orig, wins, launches = self._execute_device(jidx, plan, envs, gate, conf)
            else:
                zrows, wins, launches = self._execute_host(
                    jidx, plan, envs, jidx.sort_gate(gate), conf)
                orig = jidx.to_orig(zrows)
                if jidx.perm is not None:
                    order = _pair_order(wins, orig)
                    orig, wins = orig[order], wins[order]
            sp.set(launches=launches, candidates=plan.candidates, pairs=len(orig))
        refine_s = time.perf_counter() - t1
        metrics.join_queries.inc(strategy=plan.strategy)
        metrics.join_candidates.inc(plan.candidates)
        metrics.join_pairs.inc(len(orig))
        metrics.join_launches.inc(launches)
        if plan.splits:
            metrics.join_skew_splits.inc(plan.splits)
        metrics.join_plan_seconds.observe(plan_s)
        metrics.join_refine_seconds.observe(refine_s)
        ledger.charge("join_candidates", plan.candidates)
        ledger.charge("join_pairs", len(orig))
        return JoinResult(
            orig, wins.astype(np.int64), strategy=plan.strategy, level=plan.level,
            engine=engine, launches=launches, candidates=plan.candidates, splits=plan.splits,
            shards=0, plan_s=plan_s, refine_s=refine_s, stats=plan.stats,
        )

    # -- execution engines -------------------------------------------------

    def _run(self, fn, device: bool):
        """One refinement batch, on the scheduler's batch lane when one is
        present (device batches arm its launch watchdog)."""
        if self.sched is None:
            return fn()
        from geomesa_tpu_torch.sched.scheduler import LANE_BATCH

        return self.sched.run(fn=fn, lane=LANE_BATCH, device=device, deadline_ms=None)

    def _batches(self, plan, budget: int):
        """Run-aligned batch boundaries: maximal run prefixes whose
        candidate totals stay under the budget (the skew split bounded
        every run below it)."""
        lens = (plan.ends - plan.starts).astype(np.int64)
        csum = np.cumsum(lens)
        R = len(lens)
        out = []
        i = 0
        done = 0
        while i < R:
            j = int(np.searchsorted(csum, done + budget, side="right"))
            j = max(j, i + 1)
            out.append((i, j))
            done = int(csum[j - 1])
            i = j
        return out

    def _execute_host(self, jidx, plan, envs, gate, conf):
        rows_out: list = []
        wins_out: list = []
        launches = 0
        pl = jidx.planes
        for i, j in self._batches(plan, conf["batch_candidates"]):

            def _one(i=i, j=j):
                rows, winv, iflag = jops.expand_runs(
                    plan.starts[i:j], plan.ends[i:j] - plan.starts[i:j],
                    plan.wins[i:j], plan.interior[i:j],
                )
                if jidx.point:
                    hit = jops.refine_host(pl["x"], pl["y"], envs, rows, winv, iflag, gate)
                else:
                    hit = jops.refine_host_env(pl["x0"], pl["y0"], pl["x1"], pl["y1"], envs,
                                               rows, winv, iflag, gate)
                return rows[hit], winv[hit]

            r, w = self._run(_one, device=False)
            launches += 1
            if len(r):
                rows_out.append(r)
                wins_out.append(w)
        if not rows_out:
            e = np.empty(0, np.int64)
            return e, e.copy(), launches
        return np.concatenate(rows_out), np.concatenate(wins_out), launches

    def _device_args(self, jidx, plan, i, j, envs_dev):
        """The small run arrays of one batch on the device (starts, lens,
        their inclusive cumsum, windows, interior flags), the envelopes and
        the candidate total; None for a batch without candidates. No
        padding: the passes run eagerly at the batch's own size."""
        starts = plan.starts[i:j]
        lens = (plan.ends[i:j] - plan.starts[i:j]).astype(np.int64)
        winv = plan.wins[i:j]
        iflag = plan.interior[i:j]
        keep = lens > 0
        if not np.all(keep):
            starts, lens, winv, iflag = starts[keep], lens[keep], winv[keep], iflag[keep]
        total = int(lens.sum())
        if total == 0:
            return None
        dev = jidx.device
        up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
        return (up(starts, np.int64), up(lens, np.int64), up(np.cumsum(lens), np.int64),
                up(winv, np.int64), up(iflag, bool), envs_dev, total)

    def _execute_device(self, jidx, plan, envs, gate, conf):
        """Refine every batch on the layout's device: a count pass (one
        launch when nothing survives), else the compaction too (two).
        ``gate`` is in original-row order and is permuted on the device.
        Returns the pairs as host arrays in (window, original row) order."""
        dev = jidx.device
        planes = jidx.device_planes()
        names = ("x", "y") if jidx.point else ("x0", "y0", "x1", "y1")
        pvals = tuple(planes[k] for k in names)
        envs_dev = torch.from_numpy(np.ascontiguousarray(envs, np.float64)).to(dev)
        perm = jidx.device_perm()
        gate_dev = None
        if gate is not None:
            gate_dev = torch.from_numpy(np.ascontiguousarray(gate, bool)).to(dev)
            if perm is not None:
                gate_dev = gate_dev[perm]
        rows_out: list = []
        wins_out: list = []
        launches = 0
        for i, j in self._batches(plan, conf["batch_candidates"]):
            args = self._device_args(jidx, plan, i, j, envs_dev)
            if args is None:
                continue

            def _one(args=args):
                if jops.count_pairs(pvals, *args, gate_dev) == 0:
                    return None, 1  # the count launch only
                return jops.compact_pairs(pvals, *args, gate_dev), 2

            got, ran = self._run(_one, device=True)
            launches += ran
            if got is not None and got[0].numel():
                rows_out.append(got[0])
                wins_out.append(got[1])
        if not rows_out:
            e = np.empty(0, np.int64)
            return e, e.copy(), launches
        rows = torch.cat(rows_out)
        wins = torch.cat(wins_out)
        if perm is not None:
            rows = perm[rows]
            order = _pair_order(wins, rows, jidx.n)
            rows, wins = rows[order], wins[order]
        return rows.cpu().numpy(), wins.cpu().numpy(), launches


def filter_gate(di, f) -> np.ndarray:
    """One row gate from a filter over a resident index's staged rows:
    ``di.mask`` evaluates any filter shape (the scan kernels, with the host
    residual) with validity and the fail-closed visibility verdict ANDed
    in; rows past the mask's length stay gated off."""
    m = np.asarray(di.mask(f))
    n = len(di._host_rows())
    g = np.zeros(n, bool)
    g[: min(len(m), n)] = m[:n]
    return g


def _di_gate(di, n: int) -> "np.ndarray | None":
    """The resident index's implicit row gate: validity (a streaming
    index's evictions) ANDed with the fail-closed visibility verdict (no
    auths on the library join path: labeled rows hide). None when the
    index has neither."""
    hv = di._host_valid()
    vis = di._visid_np
    if hv is None and vis is None:
        return None
    g = np.ones(n, bool)
    if hv is not None:
        k = min(len(hv), n)
        g[:k] &= hv[:k]
    if vis is not None:
        g = di._apply_auths_np(g, None)
    return g


def _pair_order(wins, orig, n: "int | None" = None):
    """Canonical (window, original row) pair order: ``np.lexsort`` on host
    arrays, or one sort of the composite key ``win * n + row`` on tensors
    (pairs are distinct, so both give the same order)."""
    if isinstance(wins, torch.Tensor):
        return torch.sort(wins * n + orig).indices
    return np.lexsort((orig, wins))
