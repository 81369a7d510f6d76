"""Port parity for the streaming index: ``geomesa_tpu_torch``'s
``StreamingDeviceIndex(device="cpu")`` against ``geomesa_tpu``'s, under the
same sequences of ``append`` / ``evict`` / ``upsert`` / ``clear`` /
``refresh_delta`` / ``attach_live`` messages.

Both indexes stage from a store whose ``write`` mirrors the appends (the
port's ``BatchStore.write``; on the JAX side a test-local subclass of its
``BatchStore``), over float32-exact coordinates and bounds, so the JAX
package's float64 planes on the CPU and the port's float32 planes decide
every compare alike; for kNN the JAX index gets float32 coordinate planes,
as it stages them on its TPU. After every step the two indexes are held
equal on ``len``, ``count`` (loose and exact), ``mask``, the fid sets of
``query``, ``stats``, ``density``, ``fused_loose_counts``/``_query``,
``knn`` and ``window_union_query``, and on ``restages``, ``delta_appends``
and ``refresh_delta``'s modes; loose and exact counts also equal a
``DeviceIndex`` staged fresh from the live rows. Schemas: z3 on dim planes
and on the interleaved key, z2, xz2 and xz3; labeled rows under three auth
sets. Tolerance: exact; weighted density grids rtol 1e-6. The reference's
``TestStreamingDeviceIndex`` (``tests/test_device_cache.py``), its dim-plane
streaming tests (``tests/test_dimplane_cache.py``) and its delta-refresh
tests (``tests/test_stream_ingest.py``) are ported as cases here.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import StreamingDeviceIndex as JStream
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu.stream import log as jlog
from geomesa_tpu_torch import kernels, metrics
from geomesa_tpu_torch.device_cache import DeviceIndex, StreamingDeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.store.direct import BatchStore
from geomesa_tpu_torch.stream import log as tlog

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
GRID = 1024.0  # polygon corners on a 2^-10 grid: exact in float32
SPECS = {
    "z3": "count:Int,dtg:Date,name:String,*geom:Point:srid=4326",
    "z3i": "count:Int,dtg:Date,name:String,*geom:Point:srid=4326",
    "z2": "count:Int,name:String,*geom:Point:srid=4326",
    "xz2": "name:String,count:Int,*geom:Polygon:srid=4326",
    "xz3": "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326",
}
CENTERS = np.array([[10.0, 45.0], [-100.0, 40.0], [120.0, -30.0], [30.0, 5.0]])
BOX = "BBOX(geom, -10, 35, 30, 60)"
WIN = "dtg DURING 2020-01-10T00:00:00Z/2020-01-25T00:00:00Z"
LATE = "dtg DURING 2020-02-20T00:00:00Z/2020-04-10T00:00:00Z"
QUERIES = {
    "z3": [f"{BOX} AND {WIN}", "BBOX(geom, -130, 20, -60, 55)", LATE,
           f"{BOX} AND name LIKE 'a%'", "count > 500 AND BBOX(geom, -60, -30, 60, 30)", "INCLUDE"],
    "z2": [BOX, "BBOX(geom, -130, 20, -60, 55)", "BBOX(geom, 100, -50, 160, 0) AND count < 300",
           f"{BOX} AND name LIKE 'a%'", "INCLUDE"],
    "xz2": [BOX, "BBOX(geom, -130, 20, -60, 55)",
            "INTERSECTS(geom, POLYGON((-5 42, 3 40, 8 44.5, 6 51, -2 50, -5 42)))", "INCLUDE"],
    "xz3": [f"{BOX} AND {WIN}", "BBOX(geom, -130, 20, -60, 55)", f"BBOX(geom, 100, -50, 160, 0) AND {LATE}",
            "INTERSECTS(geom, POLYGON((-5 42, 3 40, 8 44.5, 6 51, -2 50, -5 42)))", "INCLUDE"],
}
QUERIES["z3i"] = QUERIES["z3"]
# the loose queries a map client fuses: one launch for the group
FUSE = {"z3": [f"{BOX} AND {WIN}", "BBOX(geom, -130, 20, -60, 55) AND " + WIN, LATE],
        "z2": [BOX, "BBOX(geom, -130, 20, -60, 55)"],
        "xz2": [BOX, "BBOX(geom, -130, 20, -60, 55)"],
        "xz3": [f"{BOX} AND {WIN}", f"BBOX(geom, 100, -50, 160, 0) AND {LATE}"]}
FUSE["z3i"] = FUSE["z3"]
STATS = {"z3": 'Count();MinMax("count");MinMax("dtg");Histogram("count",10,0,1000)',
         "z2": 'Count();MinMax("count");Histogram("count",10,0,1000)',
         "xz2": 'Count();MinMax("count")', "xz3": 'Count();MinMax("count");MinMax("dtg")'}
STATS["z3i"] = STATS["z3"]
AUTHS = [None, ("A",), ("A", "B")]
LABELS = ["", "A", "B", "A&B", "A|C"]


def _snap(v):
    return np.round(np.asarray(v, np.float64) * GRID) / GRID


def _columns(kind, n, seed, t_lo=T0, t_hi=T0 + 60 * DAY, labels=None):
    """n rows of a schema: 85% around four centres, the rest uniform;
    float32-exact points or grid-snapped rectangles; dates in [t_lo, t_hi)."""
    rng = np.random.default_rng(seed)
    xy = CENTERS[rng.integers(0, len(CENTERS), n)] + rng.normal(0, 6.0, (n, 2))
    xy = np.where(rng.random((n, 1)) < 0.85, xy, rng.uniform([-170, -80], [170, 80], (n, 2)))
    xy = np.clip(xy, [-175, -85], [175, 85]).astype(np.float32).astype(np.float64)
    cols = {"count": rng.integers(0, 1000, n),
            "name": np.array(rng.choice(["a", "b", "c"], n), dtype=object)}
    if kind.startswith("xz"):
        x, y = _snap(xy[:, 0]), _snap(xy[:, 1])
        w, h = _snap(rng.uniform(0.01, 3.0, n)), _snap(rng.uniform(0.01, 3.0, n))
        cols["geom"] = np.array([f"POLYGON (({a} {b}, {a + c} {b}, {a + c} {b + d}, {a} {b + d}, "
                                 f"{a} {b}))" for a, b, c, d in zip(x, y, w, h)], dtype=object)
    else:
        cols["geom"] = xy
    if kind != "z2" and kind != "xz2":
        cols["dtg"] = rng.integers(t_lo, t_hi, n)
    if labels is not None:
        cols[VIS_COLUMN] = np.array(rng.choice(labels, n), dtype=object)
    return cols


class _JWriteStore(JStore):
    """The reference's BatchStore with ``write`` appending rows, as its
    MemoryDataStore's does (duplicate fids stay two rows)."""

    def write(self, type_name, columns, fids=None):
        self.batch = JBatch.concat([self.batch, JBatch.from_columns(self.sft, columns, fids)])


class _JInterleaved(JStream):
    """The reference's streaming index on the interleaved key layout (its
    constructor takes no ``dim_planes``)."""

    def _dim_usable(self, kind, sfc, bins):
        return False


class _Live:
    """A live layer's listener registry: ``emit`` hands a message to every
    attached index."""

    def __init__(self):
        self.listeners = []

    def add_listener(self, fn):
        self.listeners.append(fn)

    def remove_listener(self, fn):
        self.listeners.remove(fn)

    def emit(self, msg):
        for fn in list(self.listeners):
            fn(msg)


def _jax_f32(jdi):
    """float32 coordinate planes on the JAX index, as on its TPU."""
    for c in ("geom__x", "geom__y"):
        if c in jdi._cols and jdi._cols[c].dtype != jnp.float32:
            jdi._cols[c] = jnp.asarray(np.asarray(jdi._cols[c]).astype(np.float32))


class Twin:
    """A reference streaming index and the port's over the same rows; every
    mutation goes to both (and, for new rows, to both stores)."""

    def __init__(self, kind, n=1500, seed=1, labels=None, **kw):
        self.kind = kind
        spec = SPECS[kind]
        self.jsft, self.sft = JSFT.create("t", spec), SimpleFeatureType.create("t", spec)
        cols = _columns(kind, n, seed, labels=labels)
        fids = np.arange(n)
        self.jstore = _JWriteStore(JBatch.from_columns(self.jsft, dict(cols), fids))
        self.tstore = BatchStore(FeatureBatch.from_columns(self.sft, dict(cols), fids))
        jcls = _JInterleaved if kind == "z3i" else JStream
        self.j = jcls(self.jstore, "t", z_planes=True, **kw)
        self.t = StreamingDeviceIndex(self.tstore, "t", z_planes=True, device="cpu",
                                      dim_planes=False if kind == "z3i" else None, **kw)

    def batches(self, cols, fids):
        return (JBatch.from_columns(self.jsft, dict(cols), fids),
                FeatureBatch.from_columns(self.sft, dict(cols), fids))

    def write(self, cols, fids):
        self.jstore.write("t", dict(cols), fids)
        self.tstore.write("t", dict(cols), fids)

    def append(self, cols, fids):
        self.write(cols, fids)
        jb, tb = self.batches(cols, fids)
        self.j.append(jb)
        self.t.append(tb)

    def upsert(self, cols, fids):
        jb, tb = self.batches(cols, fids)
        self.j.upsert(jb)
        self.t.upsert(tb)

    def evict(self, fids):
        self.j.evict(fids)
        self.t.evict(fids)

    def clear(self):
        self.j.clear()
        self.t.clear()

    def refresh_delta(self, cols, fids):
        self.write(cols, fids)
        jb, tb = self.batches(cols, fids)
        mode = self.t.refresh_delta(tb)
        assert mode == self.j.refresh_delta(jb)
        return mode

    def fresh(self):
        """A port DeviceIndex staged from the streaming index's live rows."""
        return DeviceIndex(BatchStore(self.t._live_rows()), "t", z_planes=True, device="cpu",
                           dim_planes=False if self.kind == "z3i" else None)

    def check(self, auths_list=(None,)):
        j, t, kind = self.j, self.t, self.kind
        assert len(t) == len(j)
        assert (t.restages, t.delta_appends) == (j.restages, j.delta_appends)
        fresh = self.fresh()
        for q in QUERIES[kind]:
            for auths in auths_list:
                for loose in (False, True):
                    c = t.count(q, loose=loose, auths=auths)
                    assert c == j.count(q, loose=loose, auths=auths), (q, loose, auths)
                    np.testing.assert_array_equal(t.mask(q, loose=loose, auths=auths),
                                                  j.mask(q, loose=loose, auths=auths))
                    np.testing.assert_array_equal(
                        np.sort(t.query(q, loose=loose, auths=auths).fids),
                        np.sort(j.query(q, loose=loose, auths=auths).fids))
                    assert c == fresh.count(q, loose=loose, auths=auths), (q, loose, "fresh")
        for auths in auths_list:
            q = QUERIES[kind][0]
            for loose in (False, True):
                assert t.stats(q, STATS[kind], loose=loose, auths=auths).to_json() == \
                    j.stats(q, STATS[kind], loose=loose, auths=auths).to_json()
        if t._vis_vocab is None:
            qs = FUSE[kind]
            assert t.fused_loose_counts(qs, loose=True) == j.fused_loose_counts(qs, loose=True)
            for a, b in zip(t.fused_loose_query(qs, loose=True), j.fused_loose_query(qs, loose=True)):
                np.testing.assert_array_equal(np.sort(a.fids), np.sort(b.fids))
        if kind.startswith("xz"):
            return
        env, jenv = Envelope(-40, 20, 60, 70), JEnvelope(-40, 20, 60, 70)
        _jax_f32(j)
        for auths in auths_list:
            q = QUERIES[kind][0]
            for loose in (False, True):
                np.testing.assert_array_equal(
                    t.density(q, env, 64, 32, loose=loose, auths=auths),
                    np.asarray(j.density(q, jenv, 64, 32, loose=loose, auths=auths)))
            np.testing.assert_allclose(
                t.density("INCLUDE", env, 32, 32, weight_attr="count", auths=auths),
                np.asarray(j.density("INCLUDE", jenv, 32, 32, weight_attr="count", auths=auths)),
                rtol=1e-6)
            for px, py, k in ((10.0, 45.0, 10), (-100.0, 40.0, 3)):
                (tb, td), (jb, jd) = t.knn(px, py, k, auths=auths), j.knn(px, py, k, auths=auths)
                np.testing.assert_array_equal(tb.fids, jb.fids)
                np.testing.assert_allclose(td, jd, rtol=1e-6)
            envs = np.array([[-5.0, 40.0, 15.0, 50.0], [-110.0, 30.0, -90.0, 50.0]])
            np.testing.assert_array_equal(
                np.sort(t.window_union_query(envs, auths=auths, base="count > 200").fids),
                np.sort(j.window_union_query(envs, auths=auths, base="count > 200").fids))


def _new(kind, n, seed, fid0, **kw):
    return _columns(kind, n, seed, **kw), np.arange(fid0, fid0 + n)


KINDS = ["z3", "z3i", "z2", "xz2", "xz3"]


@pytest.mark.parametrize("kind", KINDS)
def test_appends_take_the_delta_path(kind):
    """Appends of fresh fids copy in place (no restage), one in later bins
    than any staged row (the bin range widens and the loose bounds cache
    clears), and every answer equals the reference's and a fresh index's
    (ref TestStreamingDeviceIndex.test_append_path_matches_full_restage,
    test_streaming_append_widens_bins)."""
    tw = Twin(kind, capacity=1 << 12)
    tw.check()
    for k in range(3):
        late = {"t_lo": T0 + 60 * DAY, "t_hi": T0 + 90 * DAY} if k == 2 and kind not in ("z2", "xz2") \
            else {}
        tw.append(*_new(kind, 300, 10 + k, 100_000 + 1000 * k, **late))
    assert tw.t.restages == 1 and tw.t.delta_appends == 3
    tw.check()


@pytest.mark.parametrize("kind", KINDS)
def test_evictions_and_upserts(kind):
    """Evictions clear validity bits: counts, masks, fid sets, stats and
    density over the live rows only; an upsert moves rows (the old row
    never answers) and adds new fids (ref test_evict_and_upsert,
    test_residual_and_host_filters_respect_validity,
    test_streaming_loose_respects_validity,
    test_streaming_stats_respect_validity)."""
    tw = Twin(kind, capacity=1 << 12)
    hits = tw.t.query(QUERIES[kind][0], loose=True).fids
    gone = np.concatenate([hits[:20], np.arange(500, 650)])
    tw.evict(gone)
    tw.check()
    cols, _ = _new(kind, 60, 7, 0)
    moved = np.concatenate([np.arange(0, 40), np.arange(200_000, 200_020)])
    tw.upsert(cols, moved)
    assert len(tw.t) == len((set(range(1500)) - set(gone.tolist())) | set(moved.tolist()))
    tw.check()
    assert not set(tw.t.query(QUERIES[kind][0]).fids.tolist()) & set(hits[:20].tolist())


@pytest.mark.parametrize("kind", KINDS)
def test_growth_and_compaction_restage(kind):
    """An append past the capacity compacts the live rows and restages at
    double capacity; dead rows past the threshold compact in place; the
    restage counts equal the reference's (ref
    test_growth_compacts_and_stays_exact)."""
    tw = Twin(kind, n=1000, capacity=1024)
    for k in range(4):
        tw.append(*_new(kind, 500, 20 + k, 50_000 + 1000 * k))
    assert tw.t.restages > 1
    tw.check()
    cap = tw.t._cap
    tw.evict(np.arange(0, 1000))
    tw.evict(np.arange(50_000, 50_800))
    assert tw.t._cap == cap and tw.t._n_dead < tw.t._n  # compacted in place
    tw.check()


@pytest.mark.parametrize("kind", KINDS)
def test_refresh_delta_clear_and_live_messages(kind):
    """``refresh_delta``: fresh fids take the delta, a fid the index holds
    restages from the store (a duplicate-fid append is two store rows);
    ``clear`` empties; ``attach_live``: Put upserts, Remove evicts, Clear
    restages from the store, and after the detach nothing applies (ref
    test_attach_live_applies_deltas_not_restages,
    test_streaming_device_index_delta_refresh)."""
    tw = Twin(kind, capacity=1 << 12)
    before = metrics.stream_delta_refreshes.value(mode="delta")
    assert tw.refresh_delta(*_new(kind, 64, 30, 10_000)) == "delta"
    assert metrics.stream_delta_refreshes.value(mode="delta") == before + 1
    assert tw.t.restages == 1 and len(tw.t) == 1564
    tw.check()
    assert tw.refresh_delta(*_new(kind, 8, 31, 10_060)) == "restage"  # fids 10,060-10,063 held
    assert len(tw.t) == 1572  # the store's rows: the duplicates twice
    tw.check()
    jlive, tlive = _Live(), _Live()
    jdetach, tdetach = tw.j.attach_live(jlive), tw.t.attach_live(tlive)
    for msgs in (
        lambda c, f: (jlog.Put(c, f), tlog.Put(c, f)),
        lambda c, f: (jlog.Remove(f[:5]), tlog.Remove(f[:5])),
    ):
        for c, f in (_new(kind, 40, 32, 300_000), _new(kind, 40, 33, 100)):  # new, then upserts
            jm, tm = msgs(c, f)
            jlive.emit(jm)
            tlive.emit(tm)
    tw.check()
    jlive.emit(jlog.Clear())
    tlive.emit(tlog.Clear())  # restages from the store
    tw.check()
    jdetach()
    tdetach()
    assert not tlive.listeners
    tlive.emit(tlog.Remove(np.arange(0, 100)))
    assert len(tw.t) == len(tw.j)
    tw.clear()
    assert len(tw.t) == 0 and tw.t.count("INCLUDE") == 0
    tw.append(*_new(kind, 200, 34, 400_000))
    tw.check()


def test_labeled_rows_under_three_auth_sets():
    """A labeled stream: appends extend the vocabulary (the auth tables
    follow), evictions and upserts under three auth sets, and the first
    labeled delta on an unlabeled index restages with the new plane (ref
    test_streaming_labeled_appends)."""
    tw = Twin("z3", capacity=1 << 12, labels=LABELS)
    tw.check(AUTHS)
    tw.append(*_new("z3", 300, 40, 100_000, labels=LABELS + ["C", "B|C"]))
    assert tw.t.restages == 1
    tw.evict(np.arange(0, 300, 3))
    tw.upsert(*_new("z3", 50, 41, 200, labels=["A", ""]))
    tw.check(AUTHS)
    plain = Twin("z3", capacity=1 << 12)
    plain.append(*_new("z3", 50, 42, 90_000, labels=["secret"]))
    assert plain.t.restages == plain.j.restages == 2  # the new plane restaged
    assert plain.t.count(BOX, auths=("secret",)) >= plain.t.count(BOX)
    plain.check([None, ("secret",)])


def test_append_keeps_dim_mode_and_rebases_below_the_base():
    """A delta keeps the install's dim-plane layout and packs around the
    staged bt base; one older than every staged row repacks in a full
    restage with a lower base (ref TestStreamingDim)."""
    tw = Twin("z3", capacity=1 << 13)
    base = tw.t._bt_base
    assert tw.t._dim_mode and base == tw.j._bt_base
    tw.append(*_new("z3", 400, 50, 100_000, t_lo=T0 + 30 * DAY, t_hi=T0 + 90 * DAY))
    assert tw.t._dim_mode and tw.t.delta_appends == 1 and tw.t._bt_base == base
    tw.check()
    tw.append(*_new("z3", 300, 51, 200_000, t_lo=T0 - 30 * DAY, t_hi=T0 - 20 * DAY))
    assert tw.t.restages == tw.j.restages == 2 and tw.t._bt_base == tw.j._bt_base < base
    tw.check()
    q = "dtg DURING 2019-12-01T00:00:00Z/2019-12-15T00:00:00Z"
    assert not np.any(tw.t.mask(q) & ~tw.t.mask(q, loose=True)) and tw.t.count(q) > 0


def test_launches_cover_the_staged_rows_and_the_plane_joins_every_scan():
    """Scans see the buffers' staged rows only (views, not the capacity),
    masks have one entry per staged row, and the base index's scans pass
    no plane; the count kernels' wrappers get the plane (on the CPU their
    plain versions)."""
    tw = Twin("z3", capacity=1 << 14)
    tw.evict(np.arange(10))
    t = tw.t
    assert t._cap == 1 << 14 and t._staged_len() == 1500 and len(t) == 1490
    assert all(c.shape[0] == 1500 for c in t._cols.values())
    assert t._device_valid().shape[0] == 1500 and not t._device_valid()[:10].any()
    assert t.mask("INCLUDE").shape == (1500,)
    assert t.loose_scan_kernel(QUERIES["z3"][0]) is None
    assert t.nbytes == sum(b.numel() * b.element_size() for b in t._bufs.values()) + (1 << 14)
    seen = []
    from geomesa_tpu_torch.ops import zscan

    real = zscan.dimscan_count
    try:
        zscan.dimscan_count = lambda *a, **kw: (seen.append(kw.get("valid")), real(*a, **kw))[1]
        t.count(QUERIES["z3"][0], loose=True)
    finally:
        zscan.dimscan_count = real
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape[0] == 1500
    kernels.reset_counts()
    t.count(QUERIES["z3"][0])
    assert all(v == 0 for v in kernels.VALID_LAUNCHES.values())  # CPU: no launches


def test_scheduler_counts_while_another_thread_appends():
    """Fused loose counts through the QueryScheduler while another thread
    appends and evicts: nothing raises, every answer is a count of some
    snapshot, and once both finish the counts equal a fresh index's."""
    from geomesa_tpu_torch.sched import FusableQuery, QueryScheduler, SchedConfig

    tw = Twin("z3", capacity=1 << 13)
    t = tw.t
    qs = FUSE["z3"] * 4
    done = threading.Event()
    errors = []

    def writer():
        try:
            for k in range(12):
                _, tb = tw.batches(*_new("z3", 100, 60 + k, 500_000 + 1000 * k))
                t.append(tb)
                t.evict(np.arange(20 * k, 20 * k + 10))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)
        finally:
            done.set()

    sched = QueryScheduler(SchedConfig(max_inflight=2, fusion_window_ms=2.0, default_deadline_ms=None))
    th = threading.Thread(target=writer)
    th.start()
    got = []
    while not done.is_set() or len(got) < 3:
        reqs = [sched.submit(fuse=FusableQuery(t, q, "count", loose=True)) for q in qs]
        got.append([sched.wait(r) for r in reqs])
    th.join()
    final = [sched.wait(sched.submit(fuse=FusableQuery(t, q, "count", loose=True))) for q in qs]
    sched.close(timeout=5.0)
    assert not errors
    assert all(isinstance(c, int) and c >= 0 for row in got for c in row)
    fresh = tw.fresh()
    assert final == [fresh.count(q, loose=True) for q in qs] == t.fused_loose_counts(qs, loose=True)


def test_base_index_refresh_delta_restages_and_counts_it():
    """The base index has no validity plane: ``refresh_delta`` restages
    from the store and says so, in both packages (ref
    test_base_device_index_delta_falls_back_to_restage)."""
    from geomesa_tpu.device_cache import DeviceIndex as JIndex

    tw = Twin("z2")
    jdi = JIndex(tw.jstore, "t", z_planes=True)
    tdi = DeviceIndex(tw.tstore, "t", z_planes=True, device="cpu")
    cols, fids = _new("z2", 16, 70, 10_000)
    tw.write(cols, fids)
    before = metrics.stream_delta_refreshes.value(mode="restage")
    jb, tb = tw.batches(cols, fids)
    assert tdi.refresh_delta(tb) == jdi.refresh_delta(jb) == "restage"
    assert metrics.stream_delta_refreshes.value(mode="restage") == before + 1
    assert tdi.count("INCLUDE") == jdi.count("INCLUDE") == 1516
    live = _Live()
    detach = tdi.attach_live(live)
    tw.tstore.write("t", *_new("z2", 4, 71, 20_000))
    live.emit(tlog.Remove(np.array([0])))  # the base index restages on any message
    assert len(tdi) == 1520
    detach()
    assert not live.listeners


def test_a_streaming_index_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sft = SimpleFeatureType.create("t", SPECS["z2"])
    store = BatchStore(FeatureBatch.from_columns(sft, _columns("z2", 8, 0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingDeviceIndex(store, "t")
    assert len(StreamingDeviceIndex(store, "t", device="cpu")) == 8


def test_string_fids_through_the_live_layer():
    """String fids (the object-fid route of the fid index): Puts of one row
    at a time, a Remove of two, a Put that moves a held fid, and an evict
    of a fid never held, as the reference's attach_live test drives its
    live store."""
    spec = SPECS["z3"]
    jsft, sft = JSFT.create("t", spec), SimpleFeatureType.create("t", spec)
    cols = _columns("z3", 4, 80)
    fids = np.array([f"g{i}" for i in range(4)], dtype=object)
    j = JStream(_JWriteStore(JBatch.from_columns(jsft, dict(cols), fids)), "t", capacity=4096)
    t = StreamingDeviceIndex(BatchStore(FeatureBatch.from_columns(sft, dict(cols), fids)), "t",
                             capacity=4096, device="cpu")
    jlive, tlive = _Live(), _Live()
    j.attach_live(jlive)
    t.attach_live(tlive)
    for k in range(10):
        c = {"count": [k], "name": ["a"], "dtg": [T0 + 14 * DAY],
             "geom": np.array([[float(k), 2.0]])}
        f = np.array([f"f{k}"], dtype=object)
        jlive.emit(jlog.Put(c, f))
        tlive.emit(tlog.Put(c, f))
    gone = np.array(["f3", "f4", "nope"], dtype=object)
    jlive.emit(jlog.Remove(gone))
    tlive.emit(tlog.Remove(gone))
    c = {"count": [99], "name": ["z"], "dtg": [T0 + 14 * DAY], "geom": np.array([[100.0, 50.0]])}
    jlive.emit(jlog.Put(c, np.array(["f0"], dtype=object)))
    tlive.emit(tlog.Put(c, np.array(["f0"], dtype=object)))
    assert len(t) == len(j) == 12
    assert (t.restages, t.delta_appends) == (j.restages, j.delta_appends) == (1, 11)
    for q in ("INCLUDE", "count >= 0", "BBOX(geom, 99, 49, 101, 51)", "BBOX(geom, -1, 1, 9.5, 3)"):
        assert t.count(q) == j.count(q)
        assert sorted(t.query(q).fids) == sorted(j.query(q).fids)
    assert t.count("BBOX(geom, 99, 49, 101, 51)") == 1


def test_sustained_appends_stay_deltas():
    """100 appends of 100 rows under a capacity hint that holds them all
    take the delta path every time in both packages, and the answers
    equal the reference's (ref test_sustained_ingest_rate)."""
    tw = Twin("z3", n=1000, capacity=1 << 14)
    for k in range(100):
        tw.append(*_new("z3", 100, 200 + k, 1_000_000 + 100 * k))
    assert (tw.t.restages, tw.t.delta_appends) == (tw.j.restages, tw.j.delta_appends) == (1, 100)
    assert len(tw.t) == 11_000
    for q in QUERIES["z3"][:3]:
        for loose in (False, True):
            assert tw.t.count(q, loose=loose) == tw.j.count(q, loose=loose)
