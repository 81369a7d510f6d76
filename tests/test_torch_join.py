"""Port parity for the spatial join: ``geomesa_tpu_torch``'s join planner and
engine (``join/``, ``ops/join.py``), ``DeviceIndex.window_pairs_query`` and
``process/join.py`` ``spatial_join`` against ``geomesa_tpu``'s, on the same
seeded rows.

Both packages get the same numpy columns (float32-exact coordinates) and
the port runs on ``device="cpu"``. The join engine works on float64 host
planes in both packages: pairs, strategy, level, candidates, skew splits
and launches must be equal for the host engine and for the device engine
(the port's torch passes on CPU tensors against the JAX package's XLA
launches on its CPU). ``window_pairs_query`` compares on float32 planes in
both (the JAX index gets float32 coordinate planes, as on its TPU): pairs
and overflow counts equal. ``spatial_join``'s predicate pairs equal. All
comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.conf import prop_override as jprop
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.device_cache import StreamingDeviceIndex as JStream
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.join import JoinEngine as JEngine
from geomesa_tpu.join import engine as jengine
from geomesa_tpu.join import planner as jplanner
from geomesa_tpu.process.join import spatial_join as jspatial_join
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import metrics
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.convert import join_index_from_numpy
from geomesa_tpu_torch.device_cache import DeviceIndex, StreamingDeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.join import JoinEngine, build_envelope_layout, build_join_index, plan_join
from geomesa_tpu_torch.join import engine as tengine
from geomesa_tpu_torch.ops import join as jops
from geomesa_tpu_torch.process.join import spatial_join
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

T0 = 1_577_836_800_000
DAY = 86_400_000
PT_SPEC = "c:Int,dtg:Date,*geom:Point:srid=4326"
POLY_SPEC = "name:String,c:Int,*geom:Polygon:srid=4326"
GRID = 1024.0
STRATEGIES = ("auto", "broadcast", "grouped", "zmerge")
ENGINES = ("host", "device")


def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _snap(v):
    return np.round(np.asarray(v, np.float64) * GRID) / GRID


def _points(n, seed, span=10.0, hot=0, dup=0, labels=None):
    """n float32-exact points: uniform over [-span, span]^2, ``hot`` of them
    in one tiny cell and ``dup`` copies of one point."""
    rng = np.random.default_rng(seed)
    xy = _f32(rng.uniform(-span, span, (n, 2)))
    if hot:
        xy[:hot] = _f32(1.25 + rng.uniform(0, 1e-4, (hot, 2)))
    if dup:
        xy[hot: hot + dup] = [[-3.5, 2.25]]
    cols = {"c": np.arange(n) % 1000, "dtg": T0 + rng.integers(0, 10 * DAY, n), "geom": xy}
    if labels is not None:
        cols[VIS_COLUMN] = np.array(labels, object)[rng.integers(0, len(labels), n)]
    return cols


def _polys(n, seed, span=10.0):
    rng = np.random.default_rng(seed)
    x, y = _snap(rng.uniform(-span, span, n)), _snap(rng.uniform(-span / 2, span / 2, n))
    w, h = _snap(rng.uniform(0.01, 1.5, n)), _snap(rng.uniform(0.01, 1.5, n))
    geom = np.array([f"POLYGON (({a} {b}, {a + c} {b}, {a + c} {b + d}, {a} {b + d}, {a} {b}))"
                     for a, b, c, d in zip(x, y, w, h)], dtype=object)
    return {"name": np.array(["p"] * n, object), "c": np.arange(n), "geom": geom}


def _windows(m, seed, span=10.0, lo=0.01, hi=1.5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-span, span, (m, 2))
    h = rng.uniform(lo, hi, (m, 2))
    envs = np.concatenate([c - h, c + h], axis=1)
    if m > 7:
        envs[3::7] = envs[3::7][:, [2, 3, 0, 1]]  # every 7th inverted
    return envs


def _batches(cols, spec):
    return (JBatch.from_columns(JSFT.create("t", spec), cols),
            FeatureBatch.from_columns(SimpleFeatureType.create("t", spec), cols))


def _indexes(cols, spec, **kw):
    jb, tb = _batches(cols, spec)
    return (JIndex(JStore(jb), "t", **kw), DeviceIndex(BatchStore(tb), "t", device="cpu", **kw))


class _props:
    """One property pinned in both packages."""

    def __init__(self, **kv):
        self.kv = {k.replace("_", "."): v for k, v in kv.items()}

    def __enter__(self):
        self.ctx = [c(k, v) for k, v in self.kv.items() for c in (jprop, prop_override)]
        for c in self.ctx:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)


def _same_result(r1, r2):
    np.testing.assert_array_equal(r2.rows, r1.rows)
    np.testing.assert_array_equal(r2.wins, r1.wins)
    for k in ("strategy", "level", "engine", "candidates", "launches", "splits"):
        assert getattr(r2, k) == getattr(r1, k), k
    assert (r2.stats.to_json() if r2.stats else None) == (r1.stats.to_json() if r1.stats else None)


def _oracle(x, y, envs, gate=None):
    """numpy pairs of the inclusive float64 point-in-window join, sorted
    (window, row)."""
    rows, wins = [], []
    for j, (x0, y0, x1, y1) in enumerate(envs):
        hit = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        if gate is not None:
            hit &= gate
        r = np.nonzero(hit)[0]
        rows.append(r)
        wins.append(np.full(len(r), j))
    return np.concatenate(rows or [np.zeros(0, np.int64)]), np.concatenate(
        wins or [np.zeros(0, np.int64)])


# -- layouts and plans ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["z2", "xz2"])
def test_layout_equals_the_reference(kind):
    cols, spec = (_points(3000, 1), PT_SPEC) if kind == "z2" else (_polys(800, 2), POLY_SPEC)
    jb, tb = _batches(cols, spec)
    want = jengine.build_join_index(jb, jb.sft, 8)
    got = build_join_index(tb, tb.sft, 8, device="cpu")
    assert got.kind == want.kind and got.n == want.n
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.hist_prefix, want.hist_prefix)
    for k, v in want.planes.items():
        np.testing.assert_array_equal(got.planes[k], v)


def test_envelope_layout_equals_the_reference():
    envs = _windows(300, 5)
    envs = envs[(envs[:, 0] <= envs[:, 2]) & (envs[:, 1] <= envs[:, 3])]
    want = jengine.build_envelope_layout(envs, hist_bits=6)
    got = build_envelope_layout(envs, hist_bits=6)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.hist_prefix, want.hist_prefix)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", ["z2", "xz2"])
@pytest.mark.parametrize("m", [1, 40, 300])
def test_plan_join_equals_the_reference(kind, strategy, m):
    cols, spec = (_points(4000, 3, hot=1500), PT_SPEC) if kind == "z2" else (
        _polys(900, 4), POLY_SPEC)
    jb, _ = _batches(cols, spec)
    jidx = jengine.build_join_index(jb, jb.sft, 8)
    tidx = join_index_from_numpy(jidx.kind, jidx.keys, jidx.perm, jidx.planes,
                                 jidx.hist_prefix, jidx.hist_bits, xz_precision=jb.sft.xz_precision)
    envs = _windows(m, 6 + m, lo=0.001, hi=3.0)
    conf = dict(jengine._join_conf(), strategy=strategy, split_rows=1024)
    want = jplanner.plan_join(jidx, envs, conf)
    got = plan_join(tidx, envs, conf)
    for k in ("strategy", "level", "splits", "forced"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("starts", "ends", "wins", "interior"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.stats.to_json() == want.stats.to_json()


def test_argsort_u64_is_a_stable_argsort():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 62, 5000, dtype=np.int64).astype(np.uint64)
    keys[::3] = keys[0]  # ties keep row order
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(tengine.jp._argsort_u64(keys), want)
    got = tengine.jp._argsort_u64(torch.from_numpy(keys.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the refinement passes -------------------------------------------------------


@pytest.mark.parametrize("n_planes", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_torch_passes_equal_the_host_twin(n_planes, gated):
    rng = np.random.default_rng(n_planes + gated)
    n, m = 2000, 30
    planes = [rng.uniform(-5, 5, n) for _ in range(2)]
    if n_planes == 4:
        planes += [planes[0] + rng.uniform(0, 1, n), planes[1] + rng.uniform(0, 1, n)]
    envs = _windows(m, 9, span=5.0)
    starts = rng.integers(0, n - 100, 50)
    lens = rng.integers(0, 100, 50)
    wins = rng.integers(0, m, 50)
    interior = rng.random(50) < 0.2
    gate = rng.random(n) < 0.7 if gated else None
    rows, winv, iflag = jops.expand_runs(starts, lens, wins, interior)
    fn = jops.refine_host if n_planes == 2 else jops.refine_host_env
    hit = fn(*planes, envs, rows, winv, iflag, gate)
    keep = lens > 0
    t = lambda a, dt=torch.int64: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    args = (tuple(t(p, torch.float64) for p in planes), t(starts[keep]), t(lens[keep]),
            t(np.cumsum(lens[keep])), t(wins[keep]), t(interior[keep], torch.bool),
            t(envs, torch.float64), int(lens.sum()))
    g = None if gate is None else t(gate, torch.bool)
    assert jops.count_pairs(*args, g) == int(hit.sum())
    r, w = jops.compact_pairs(*args, g)
    np.testing.assert_array_equal(r.numpy(), rows[hit])
    np.testing.assert_array_equal(w.numpy(), winv[hit])


# -- the engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def points():
    cols = _points(6000, 11, hot=1800, dup=40)
    jb, tb = _batches(cols, PT_SPEC)
    return cols, jb, tb


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("m", [0, 1, 65, 400])
def test_engine_equals_the_reference(points, engine, strategy, m):
    cols, jb, tb = points
    envs = _windows(m, 20 + m, lo=0.001, hi=2.0)
    if m:
        envs[0] = [1.0, 1.0, 1.5, 1.5]  # the hot cell: the skew split
        envs[-1] = [-3.5, 2.25, -3.5, 2.25]  # a zero-area window on the duplicates
    with _props(join_engine=engine, join_strategy=strategy, join_split_rows=1024,
                join_batch_candidates=4096):
        want = JEngine(batch=jb, sft=jb.sft).join(envs)
        got = JoinEngine(batch=tb, sft=tb.sft, device="cpu").join(envs)
    _same_result(want, got)
    if m:
        r, w = _oracle(cols["geom"][:, 0], cols["geom"][:, 1], envs)
        np.testing.assert_array_equal(got.rows, r)
        np.testing.assert_array_equal(got.wins, w)
        assert m == 1 or strategy not in ("grouped", "zmerge") or got.splits > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_gate_and_xz2_equal_the_reference(engine):
    cols = _polys(1200, 13)
    jb, tb = _batches(cols, POLY_SPEC)
    gate = np.random.default_rng(1).random(len(tb)) < 0.6
    envs = _windows(90, 14)
    with _props(join_engine=engine):
        for g in (None, gate):
            _same_result(JEngine(batch=jb, sft=jb.sft).join(envs, gate=g),
                         JoinEngine(batch=tb, sft=tb.sft, device="cpu").join(envs, gate=g))


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_tiny_sides(n, engine):
    cols = _points(n, 3)
    jb, tb = _batches(cols, PT_SPEC)
    envs = np.array([[-20.0, -20.0, 20.0, 20.0], [5.0, 5.0, 4.0, 4.0]])
    with _props(join_engine=engine):
        _same_result(JEngine(batch=jb, sft=jb.sft).join(envs),
                     JoinEngine(batch=tb, sft=tb.sft, device="cpu").join(envs))


def test_engine_on_a_layout_carried_across():
    cols = _points(3000, 21)
    jb, _ = _batches(cols, PT_SPEC)
    jidx = jengine.build_join_index(jb, jb.sft, 8)
    tidx = join_index_from_numpy(jidx.kind, jidx.keys, jidx.perm, jidx.planes,
                                 jidx.hist_prefix, jidx.hist_bits)
    envs = _windows(120, 22)
    for engine in ENGINES:
        with _props(join_engine=engine):
            _same_result(JEngine(jidx=jidx).join(envs), JoinEngine(jidx=tidx).join(envs))


def test_auto_engine_resolves_by_the_device(points):
    _, _, tb = points
    res = JoinEngine(batch=tb, sft=tb.sft, device="cpu").join(_windows(70, 1))
    assert res.engine == "host"
    with pytest.raises(NotImplementedError, match="item 7"):
        JoinEngine(batch=tb, sft=tb.sft, device="cpu", mesh=object())


def test_engine_metrics_and_spans(points):
    from geomesa_tpu_torch.tracing import TRACER

    _, _, tb = points
    before = (metrics.join_pairs.value(), metrics.join_launches.value(),
              metrics.join_skew_splits.value())
    with _props(join_split_rows=1024), TRACER.trace("join") as tr:
        res = JoinEngine(batch=tb, sft=tb.sft, device="cpu").join([[1.0, 1.0, 1.5, 1.5]])
    assert metrics.join_pairs.value() - before[0] == res.pairs
    assert metrics.join_launches.value() - before[1] == res.launches
    assert metrics.join_skew_splits.value() - before[2] == res.splits > 0
    names = {s.name for s in tr.root.children}
    assert {"join.plan", "join.refine"} <= names


# -- the resident index: gates, labels, the staged generation -----------------


@pytest.mark.parametrize("engine", ENGINES)
def test_index_join_with_filter_gate_and_labels(engine):
    cols = _points(5000, 31, labels=["", "A", "B"])
    jdi, tdi = _indexes(cols, PT_SPEC, z_planes=True)
    envs = _windows(80, 32)
    with _props(join_engine=engine):
        for f in (None, "c > 300", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                  "2020-01-02T00:00:00Z/2020-01-05T00:00:00Z"):
            jg = None if f is None else jengine.filter_gate(jdi, f)
            tg = None if f is None else tengine.filter_gate(tdi, f)
            if f is not None:
                np.testing.assert_array_equal(tg, jg)
            _same_result(JEngine(jdi).join(envs, gate=jg), JoinEngine(tdi).join(envs, gate=tg))


class _JWriteStore(JStore):
    def write(self, type_name, columns, fids=None):
        self.batch = JBatch.concat([self.batch, JBatch.from_columns(self.sft, columns, fids)])


def test_streaming_join_follows_the_staged_generation():
    """The join layout is rebuilt after every mutation (append, evict,
    upsert, clear, restage) and reused between them; pairs cover only the
    live rows and equal the reference's streaming index."""
    cols = _points(3000, 41)
    jb, tb = _batches(cols, PT_SPEC)
    jdi = JStream(_JWriteStore(jb), "t", z_planes=True)
    tdi = StreamingDeviceIndex(BatchStore(tb), "t", z_planes=True, device="cpu")
    envs = _windows(100, 42)
    rng = np.random.default_rng(43)

    def check():
        for engine in ENGINES:
            with _props(join_engine=engine):
                want = JEngine(jdi).join(envs)
                got = JoinEngine(tdi).join(envs)
                _same_result(want, got)
        live = tdi._host_valid()
        x, y = tdi._host_rows().point_coords()
        r, w = _oracle(x, y, envs, gate=live)
        np.testing.assert_array_equal(got.rows, r)
        np.testing.assert_array_equal(got.wins, w)

    def step(fn):
        gen = tdi._gen
        layout = tdi._join_index
        fn()
        assert tdi._gen > gen
        check()
        assert tdi._join_index is not layout and tdi._join_index.gen == tdi._gen
        kept = tdi._join_index
        JoinEngine(tdi).join(envs)
        assert tdi._join_index is kept  # reused while nothing changes

    check()
    new = _points(200, 44)
    fids = np.arange(10_000, 10_200)
    step(lambda: (jdi.append(JBatch.from_columns(jb.sft, new, fids)),
                  tdi.append(FeatureBatch.from_columns(tb.sft, new, fids))))
    gone = rng.choice(3000, 400, replace=False)
    step(lambda: (jdi.evict(gone), tdi.evict(gone)))
    moved = _points(50, 45)
    mf = np.arange(50)
    step(lambda: (jdi.upsert(JBatch.from_columns(jb.sft, moved, mf)),
                  tdi.upsert(FeatureBatch.from_columns(tb.sft, moved, mf))))
    step(lambda: (jdi.refresh(), tdi.refresh()))
    step(lambda: (jdi.clear(), tdi.clear()))


# -- window pairs ----------------------------------------------------------------


def _jpairs(cols, spec=PT_SPEC, **kw):
    jdi, tdi = _indexes(cols, spec, **kw)
    for c in ("geom__x", "geom__y"):
        jdi._cols[c] = jnp.asarray(np.asarray(jdi._cols[c]).astype(np.float32))
    return jdi, tdi


def _same_pairs(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("m", [0, 1, 64, 65, 600])
def test_window_pairs_equal_the_reference(m):
    cols = _points(4000, 51)
    jdi, tdi = _jpairs(cols)
    envs = _windows(m, 52 + m)
    if m:
        # edges exactly on rows, and one float32 ulp either side of a row
        x0, y0 = cols["geom"][0]
        envs[0] = [x0, y0, x0 + 1, y0 + 1]
        x1, y1 = cols["geom"][1]
        envs[-1] = [np.nextafter(np.float32(x1), np.float32(np.inf)), y1 - 1, x1 + 1, y1 + 1]
    got = tdi.window_pairs_query(envs)
    _same_pairs(got, jdi.window_pairs_query(envs))
    if m > 1:
        assert 0 in got[0][got[1] == 0] and 1 in got[0][got[1] == m - 1]


def test_window_pairs_base_filter_and_auths():
    cols = _points(5000, 61, labels=["", "A", "B", "A&B"])
    jdi, tdi = _jpairs(cols, z_planes=True)
    envs = _windows(130, 62)
    base = "c > 200 AND dtg DURING 2020-01-02T00:00:00Z/2020-01-06T00:00:00Z"
    for auths in (None, ("A",), ("A", "B")):
        for b in (None, base):
            _same_pairs(tdi.window_pairs_query(envs, auths=auths, base=b),
                        jdi.window_pairs_query(envs, auths=auths, base=b))
    # a base filter with a host residual is not on the device: None in both
    res = "c > 200 AND TOUCHES(geom, POLYGON((0 0, 3 0, 3 3, 0 0)))"
    assert tdi.window_pairs_query(envs, base=res) is None
    assert jdi.window_pairs_query(envs, base=res) is None


def test_window_pairs_overflow_refetches_the_full_group():
    """At 2^17 rows the compaction cap C is 4096: dense groups overflow
    into the full word plane, and the overflow counts agree."""
    n = 1 << 17
    cols = _points(n, 71, span=4.0)
    jdi, tdi = _jpairs(cols)
    envs = np.concatenate([_windows(70, 72, span=4.0, lo=0.5, hi=3.0),
                           np.array([[-4.0, -4.0, 4.0, 4.0]])])
    j0 = jmetrics.join_pair_overflows.value()
    t0 = metrics.join_pair_overflows.value()
    _same_pairs(tdi.window_pairs_query(envs), jdi.window_pairs_query(envs))
    dj = jmetrics.join_pair_overflows.value() - j0
    dt = metrics.join_pair_overflows.value() - t0
    assert dt == dj == 2


def test_window_pairs_on_a_streaming_index_after_evictions():
    cols = _points(3000, 81)
    jb, tb = _batches(cols, PT_SPEC)
    jdi = JStream(_JWriteStore(jb), "t")
    tdi = StreamingDeviceIndex(BatchStore(tb), "t", device="cpu")
    gone = np.random.default_rng(82).choice(3000, 500, replace=False)
    jdi.evict(gone)
    tdi.evict(gone)
    for c in ("geom__x", "geom__y"):
        jdi._cols[c] = jnp.asarray(np.asarray(jdi._cols[c]).astype(np.float32))
    envs = _windows(70, 83)
    _same_pairs(tdi.window_pairs_query(envs), jdi.window_pairs_query(envs))


# -- spatial_join ----------------------------------------------------------------


def _store_pair(cols, spec):
    jb, tb = _batches(cols, spec)
    jstore = JStore(jb)
    tstore = BatchStore(tb)
    return jstore, tstore, JIndex(jstore, "t"), DeviceIndex(tstore, "t", device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_spatial_join_envelope_equals_the_reference(engine):
    cols = _points(4000, 91)
    jstore, tstore, jdi, tdi = _store_pair(cols, PT_SPEC)
    envs = _windows(70, 92)
    with _props(join_engine=engine):
        for kw in ({}, {"distance": 0.05}, {"left_filter": "c < 500"}):
            _same_result(jspatial_join(jstore, "t", envs, device_index=jdi, **kw),
                         spatial_join(tstore, "t", envs, device_index=tdi, **kw))


_RIGHT_SPEC = "rname:String,*geom:Polygon:srid=4326"
_RIGHT_PTS = "rname:String,*geom:Point:srid=4326"


def _right(kind):
    if kind == "points":
        xy = _f32(np.random.default_rng(5).uniform(-8, 8, (20, 2)))
        return _RIGHT_PTS, {"rname": np.array(["s"] * 20, object), "geom": xy}
    rings = []
    rng = np.random.default_rng(6)
    for i in range(6):
        cx, cy = rng.uniform(-7, 7, 2)
        k = 12 + 4 * i
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(0.8, 2.5, k)
        pts = [f"{cx + r * np.cos(a)} {cy + r * np.sin(a)}" for a, r in zip(ang, rad)]
        rings.append(f"POLYGON (({', '.join(pts + pts[:1])}))")
    return _RIGHT_SPEC, {"rname": np.array(["b"] * 6, object), "geom": np.array(rings, object)}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("left,right,on", [
    ("points", "polygons", "intersects"), ("points", "polygons", "within"),
    ("polygons", "polygons", "contains"), ("polygons", "points", "intersects"),
    ("points", "points", "dwithin"), ("polygons", "polygons", "dwithin"),
])
def test_spatial_join_predicates_equal_the_reference(engine, left, right, on):
    cols, spec = (_points(3000, 93), PT_SPEC) if left == "points" else (_polys(600, 94), POLY_SPEC)
    jstore, tstore, jdi, tdi = _store_pair(cols, spec)
    rspec, rcols = _right(right)
    jr = JBatch.from_columns(JSFT.create("r", rspec), rcols)
    tr = FeatureBatch.from_columns(SimpleFeatureType.create("r", rspec), rcols)
    dist = 0.3 if on == "dwithin" else None
    lf = "c < 700" if left == "points" else None
    with _props(join_engine=engine):
        jl, _, jp = jspatial_join(jstore, "t", jr, on=on, distance=dist, left_filter=lf,
                                  device_index=jdi)
        tl, trr, tp = spatial_join(tstore, "t", tr, on=on, distance=dist, left_filter=lf,
                                   device_index=tdi)
    assert trr is tr
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl.fids, jl.fids)


def test_spatial_join_store_path_raises():
    """The store-path shapes (an envelope join without a device_index, a
    type name on the right, a FeatureBatch on the right without an index)
    answer as the reference's, over memory stores; a dwithin join without a
    distance still raises."""
    from geomesa_tpu.store.memory import MemoryDataStore as JMemory
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    cols = _points(600, 95)
    rspec, rcols = _right("polygons")
    tstore, jstore = MemoryDataStore(device="cpu"), JMemory()
    for ds in (tstore, jstore):
        ds.create_schema("t", PT_SPEC)
        ds.create_schema("other", rspec)
        ds.write("t", cols)
        ds.write("other", rcols)
    tr = FeatureBatch.from_columns(SimpleFeatureType.create("r", rspec), rcols)
    jr = JBatch.from_columns(JSFT.create("r", rspec), rcols)
    envs = _windows(12, 96)
    envs = np.concatenate([np.minimum(envs[:, :2], envs[:, 2:]), np.maximum(envs[:, :2], envs[:, 2:])], 1)
    got, want = spatial_join(tstore, "t", envs), jspatial_join(jstore, "t", envs)
    assert got.pairs > 0
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.wins, want.wins)
    for right, jright in (("other", "other"), (tr, jr)):
        tl, _, tp = spatial_join(tstore, "t", right, on="within")
        jl, _, jp = jspatial_join(jstore, "t", jright, on="within")
        assert len(tp) > 0
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tl.fids, jl.fids)
    _, _, _, tdi = _store_pair(cols, PT_SPEC)
    with pytest.raises(ValueError, match="distance"):
        spatial_join(tstore, "t", tr, on="dwithin", device_index=tdi)


def _point_windows(m, seed):
    """Point windows: random, on dyadic grid lines of the XZ levels (in
    normalized space), and on the world's edges and corners."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-12, -7], [12, 7], (m, 2))
    grid = np.array([[-180 + 360 * k / 2 ** lv, -90 + 180 * j / 2 ** lv]
                     for lv in (3, 7, 12) for k, j in ((2 ** lv // 2, 2 ** lv // 2),
                                                       (2 ** lv // 2 + 1, 2 ** lv // 2 - 1))])
    edges = np.array([[-180, -90], [180, 90], [-180, 90], [180, -90], [0, 0], [-180, 0]], float)
    p = np.concatenate([pts, grid, edges])
    return np.concatenate([p, p], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_windows_cover_the_cells_of_an_unbudgeted_walk(seed):
    """The planner's vectorized cover of a point window holds exactly the
    cells the XZ walk matches when its budget never binds: the same
    candidate rows, so every envelope that overlaps the point."""
    from geomesa_tpu_torch.join import planner as tplanner

    cols = _polys(1500, 20 + seed)
    env = np.asarray(FeatureBatch.from_columns(SimpleFeatureType.create("t", POLY_SPEC), cols)
                     .bboxes("geom"), np.float64)
    env = np.concatenate([env, [[-180, -90, -180, -90], [180, 90, 180, 90], [0, 0, 0, 0],
                                [-181, -91, 181, 91]]])
    jidx = build_envelope_layout(env, hist_bits=6)
    wins = tplanner.clip_envs(_point_windows(300, seed))
    starts, ends, w, interior = tplanner._xz_runs(jidx.keys, jidx.sfc, wins, 32)
    assert not interior.any() and (np.diff(w) >= 0).all()
    for j in range(len(wins)):
        a, b, c, d = wins[j]
        got = np.concatenate([np.arange(s, e) for s, e in zip(starts[w == j], ends[w == j])] or
                             [np.empty(0, np.int64)])
        walk = jidx.sfc.ranges(a, b, c, d, max_ranges=10 ** 9)
        want = np.concatenate([np.arange(np.searchsorted(jidx.keys, np.uint64(r.lower)),
                                         np.searchsorted(jidx.keys, np.uint64(r.upper + 1)))
                               for r in walk] or [np.empty(0, np.int64)])
        np.testing.assert_array_equal(np.sort(got), np.sort(want))
        planes = jidx.planes
        overlap = np.nonzero((planes["x0"] <= a) & (planes["x1"] >= a) & (planes["y0"] <= b)
                             & (planes["y1"] >= b))[0]
        assert np.isin(overlap, got).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_point_windows_join_as_the_reference(engine):
    """Point windows against an envelope layout (the push tier's match):
    the pairs equal the reference's, whose planner walks each window."""
    cols = _polys(1200, 31)
    jb, tb = _batches(cols, POLY_SPEC)
    env = np.asarray(tb.bboxes("geom"), np.float64)
    wins = _point_windows(500, 9)
    want = JEngine(jidx=jengine.build_envelope_layout(env, hist_bits=6)).join(wins)
    with prop_override("join.engine", engine):
        got = JoinEngine(jidx=build_envelope_layout(env, hist_bits=6)).join(wins)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.wins, want.wins)
    assert len(got.rows) > 500
