"""Port parity for the window-union scan and the corridor processes:
``geomesa_tpu_torch``'s ``ops/window.py``, ``DeviceIndex.window_union_query``
/ ``bbox_window_query``, ``process/tube.py`` and ``process/proximity.py``
against ``geomesa_tpu``'s, on the same seeded rows.

Both packages get the same numpy columns (float32-exact coordinates) in a
``BatchStore`` and a ``DeviceIndex`` (the port's on ``device="cpu"``); the
JAX index's coordinate planes are float32, as it stages them on its TPU,
so both widen windows by one float32 ulp. Tolerances: fid sets and row
order equal; proximity distances equal (both take them in float64 from
the same host coordinates). The reference tests of the processes' store
paths (``tests/test_process.py`` TestKnn, ``tests/test_process_more.py``
resident-vs-store) are ported with the JAX package's ``MemoryDataStore``
answering the store side; the last tests hold the port's own
``MemoryDataStore`` against it, and check that a ``BatchStore`` serves no
filtered query in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.geom import LineString as JLine
from geomesa_tpu.geom import Point as JPoint
from geomesa_tpu.geom import Polygon as JPolygon
from geomesa_tpu.process.knn import knn as jknn
from geomesa_tpu.process.proximity import proximity_search as jproximity
from geomesa_tpu.process.tube import tube_select as jtube
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu.store.memory import MemoryDataStore
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import LineString, MultiPoint, Point, Polygon
from geomesa_tpu_torch.ops.window import union_mask, widen
from geomesa_tpu_torch.process.knn import _dist_deg, knn
from geomesa_tpu_torch.process.proximity import proximity_search
from geomesa_tpu_torch.process.tube import tube_select
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

T0 = 1_577_836_800_000
DAY = 86_400_000
SPEC = "c:Int,dtg:Date,*geom:Point:srid=4326"


def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _cols(n, seed, span=10.0, labels=None):
    rng = np.random.default_rng(seed)
    cols = {
        "c": np.arange(n),
        "dtg": T0 + rng.integers(0, DAY, n),
        "geom": _f32(rng.uniform(-span, span, (n, 2))),
    }
    if labels is not None:
        cols[VIS_COLUMN] = np.array(labels, object)[rng.integers(0, len(labels), n)]
    return cols


def _pair(cols, spec=SPEC):
    """(JAX index, port index, port store) over the same rows; the JAX
    index's coordinate planes float32, as on its TPU."""
    jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("ais", spec), cols)), "ais")
    for c in ("geom__x", "geom__y"):
        jdi._cols[c] = jnp.asarray(np.asarray(jdi._cols[c]).astype(np.float32))
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("ais", spec), cols))
    return jdi, DeviceIndex(store, "ais", device="cpu"), store


def _memory_store(cols, spec=SPEC):
    ds = MemoryDataStore()
    ds.create_schema("ais", spec)
    ds.write("ais", {k: v for k, v in cols.items() if k != VIS_COLUMN})
    return ds


@pytest.fixture(scope="module")
def world():
    cols = _cols(5000, seed=12)
    return (cols, *_pair(cols))


def _np_union(x, y, env, t=None, times=None):
    """numpy oracle of the union mask: a loop over the widened windows."""
    out = np.zeros(len(x), bool)
    for i, (x0, y0, x1, y1) in enumerate(env):
        m = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        if times is not None:
            m &= (t >= times[i, 0]) & (t <= times[i, 1])
        out |= m
    return out


def _windows(m, seed, span=10.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-span, span, (m, 2))
    h = rng.uniform(0.01, 2.0, (m, 2))
    envs = np.concatenate([c - h, c + h], axis=1)
    envs[3::7] = envs[3::7][:, [2, 3, 0, 1]]  # every 7th inverted
    t0 = T0 + rng.integers(0, DAY, m)
    times = np.stack([t0, t0 + rng.integers(0, DAY // 4, m)], axis=1)
    return envs, times


@pytest.mark.parametrize("with_times", [False, True], ids=["bbox", "bbox+time"])
@pytest.mark.parametrize("m", [0, 1, 2, 64, 257])
def test_union_mask_matches_numpy(m, with_times):
    cols = _cols(3000, seed=m)
    envs, times = _windows(m, seed=m + 1)
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    t = cols["dtg"]
    env = widen(envs)
    want = _np_union(x, y, env, t, times if with_times else None)
    lanes = (torch.from_numpy((t >> 32).astype(np.int32)),
             torch.from_numpy((t & 0xFFFFFFFF).astype(np.uint32))) if with_times else (None, None)
    got = union_mask(torch.from_numpy(x), torch.from_numpy(y), env, *lanes,
                     times=times if with_times else None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_widen_is_one_float32_ulp_outward():
    e = widen([[1.0, -2.0, 3.0, 4.0], [0.1, 0.2, 0.1, 0.2]])
    assert e.dtype == np.float32
    np.testing.assert_array_equal(e[0], [np.nextafter(np.float32(1), np.float32(-np.inf)),
                                         np.nextafter(np.float32(-2), np.float32(-np.inf)),
                                         np.nextafter(np.float32(3), np.float32(np.inf)),
                                         np.nextafter(np.float32(4), np.float32(np.inf))])
    assert e[1, 0] < np.float32(0.1) < e[1, 2]


def test_union_mask_windows_with_nan_bounds_match_nothing():
    x = torch.tensor([0.0, 1.0, 5.0])
    y = torch.tensor([0.0, 1.0, 5.0])
    env = widen([[np.nan, -1, 2, 2], [4, 4, 6, 6]])
    assert union_mask(x, y, env).tolist() == [False, False, True]
    assert not union_mask(x, y, widen([[np.nan] * 4])).any()


def _edge_rows():
    """Rows on the edges of the box (1, 2, 3, 4) and one and two float32
    ulps inside and outside each edge."""
    pts = []
    for axis, v in ((0, 1.0), (0, 3.0), (1, 2.0), (1, 4.0)):
        e = np.float32(v)
        up, dn = np.float32(np.inf), np.float32(-np.inf)
        for w in (e, np.nextafter(e, up), np.nextafter(e, dn),
                  np.nextafter(np.nextafter(e, up), up), np.nextafter(np.nextafter(e, dn), dn)):
            p = [2.0, 3.0]
            p[axis] = float(w)
            pts.append(p)
    return np.array(pts)


def test_window_edges_one_ulp_match_the_reference():
    pts = _edge_rows()
    n = len(pts)
    cols = {"c": np.arange(n), "dtg": np.full(n, T0), "geom": pts}
    jdi, tdi, _ = _pair(cols)
    for env in ([1.0, 2.0, 3.0, 4.0], [3.0, 2.0, 1.0, 4.0]):  # the box, then inverted
        got = tdi.window_union_query(np.array([env]))
        np.testing.assert_array_equal(got.fids, jdi.window_union_query(np.array([env])).fids)
    got = tdi.bbox_window_query(1.0, 2.0, 3.0, 4.0)
    # the edge, one ulp inside and one ulp outside match; two ulps out do not
    assert len(got) == n - 4
    np.testing.assert_array_equal(got.fids, jdi.bbox_window_query(1.0, 2.0, 3.0, 4.0).fids)
    assert len(tdi.bbox_window_query(3.0, 2.0, 1.0, 4.0)) == 0


@pytest.mark.parametrize("base", [None, "INCLUDE", "c < 2000", "c > 100 AND dtg AFTER 2020-01-01T06:00:00Z"])
@pytest.mark.parametrize("with_times", [False, True], ids=["bbox", "bbox+time"])
@pytest.mark.parametrize("m", [1, 2, 64, 257])
def test_window_union_query_matches_the_reference(world, m, with_times, base):
    _, jdi, tdi, _ = world
    envs, times = _windows(m, seed=m + 7)
    t = times if with_times else None
    got = tdi.window_union_query(envs, t, base=base)
    want = jdi.window_union_query(envs, t, base=base)
    np.testing.assert_array_equal(got.fids, want.fids)
    if m == 1:
        b = tdi.bbox_window_query(*envs[0])
        np.testing.assert_array_equal(b.fids, jdi.bbox_window_query(*envs[0]).fids)


@pytest.mark.parametrize("auths", [None, (), ("A",), ("A", "B")], ids=repr)
def test_window_union_query_auths(auths):
    cols = _cols(2000, seed=4, labels=["", "A", "A&B", "B"])
    jdi, tdi, _ = _pair(cols)
    envs, times = _windows(16, seed=5)
    for t, base in ((None, None), (times, None), (times, "c < 1500")):
        got = tdi.window_union_query(envs, t, auths=auths, base=base)
        want = jdi.window_union_query(envs, t, auths=auths, base=base)
        np.testing.assert_array_equal(got.fids, want.fids)
        if not auths:
            assert len(got) and set(got.visibilities) == {""}  # fail closed


def test_window_union_query_returns_none_as_the_reference():
    # no date field: time windows cannot run; a base with a host residual
    # cannot fuse; a non-point schema has no point planes
    spec = "c:Int,name:String,*geom:Point:srid=4326"
    n = 100
    rng = np.random.default_rng(2)
    cols = {"c": np.arange(n), "name": np.array(["a", "b"] * 50, object),
            "geom": _f32(rng.uniform(-5, 5, (n, 2)))}
    jdi, tdi, _ = _pair(cols, spec)
    envs = np.array([[-1.0, -1.0, 1.0, 1.0]])
    times = np.array([[T0, T0 + DAY]])
    assert tdi.window_union_query(envs, times) is None is jdi.window_union_query(envs, times)
    assert tdi.window_union_query(envs, base="name LIKE 'a%'") is None
    assert jdi.window_union_query(envs, base="name LIKE 'a%'") is None
    np.testing.assert_array_equal(tdi.window_union_query(envs, base="c < 50").fids,
                                  jdi.window_union_query(envs, base="c < 50").fids)
    pspec = "name:String,*geom:Polygon:srid=4326"
    poly = {"name": ["a"], "geom": ["POLYGON((0 0, 1 0, 1 1, 0 0))"]}
    pdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(
        SimpleFeatureType.create("p", pspec), poly)), "p", device="cpu")
    assert pdi.window_union_query(envs) is None and pdi.bbox_window_query(0, 0, 1, 1) is None


def test_window_union_query_empty_index():
    cols = {"c": np.zeros(0, np.int64), "dtg": np.zeros(0, np.int64), "geom": np.zeros((0, 2))}
    _, tdi, _ = _pair(cols)
    assert len(tdi.window_union_query(np.array([[0.0, 0.0, 1.0, 1.0]]), base="c > 1")) == 0


def _track(m, seed=0):
    rng = np.random.default_rng(seed)
    xy = np.stack([np.linspace(-8, 8, m), np.linspace(-6, 7, m) + 0.5 * np.sin(np.arange(m))], axis=1)
    xy += rng.normal(0, 0.1, xy.shape)
    t = T0 + np.linspace(0, DAY, m).astype(np.int64)
    return xy, t


@pytest.mark.parametrize("base", [None, "c < 2500"])
@pytest.mark.parametrize("buffer_deg,max_dt_ms", [(0.2, 900_000), (1.5, 3_600_000), (3.0, 7_200_000)])
@pytest.mark.parametrize("m", [2, 13, 65])
def test_tube_select_matches_the_reference(world, m, buffer_deg, max_dt_ms, base):
    _, jdi, tdi, store = world
    xy, t = _track(m, seed=m)
    got = tube_select(store, "ais", xy, t, buffer_deg, max_dt_ms, base_filter=base, device_index=tdi)
    want = jtube(jdi.store, "ais", xy, t, buffer_deg, max_dt_ms, base_filter=base, device_index=jdi)
    np.testing.assert_array_equal(got.fids, want.fids)


def test_tube_select_auths():
    cols = _cols(3000, seed=8, labels=["", "A"])
    jdi, tdi, store = _pair(cols)
    xy, t = _track(9)
    for auths in (None, ("A",)):
        got = tube_select(store, "ais", xy, t, 1.5, 3_600_000, device_index=tdi, auths=auths)
        want = jtube(jdi.store, "ais", xy, t, 1.5, 3_600_000, device_index=jdi, auths=auths)
        np.testing.assert_array_equal(got.fids, want.fids)


def _inputs(pkg):
    P, L, G = (Point, LineString, Polygon) if pkg == "port" else (JPoint, JLine, JPolygon)
    return {
        "points": [(-5.0, -2.0), (3.0, 4.0), (8.0, -8.0)],
        "point_objects": [P(0.5, 0.0), P(2.5, 0.2)],
        "line": [L(np.array([[-6.0, -6.0], [0.0, 1.0], [6.0, 2.0]]))],
        "polygon": [G(np.array([[1.0, 1.0], [4.0, 1.0], [4.0, 3.0], [1.0, 1.0]]))],
    }


@pytest.mark.parametrize("base", [None, "c < 2000"])
@pytest.mark.parametrize("dist", [0.1, 1.0])
@pytest.mark.parametrize("kind", ["points", "point_objects", "line", "polygon"])
def test_proximity_matches_the_reference(world, kind, dist, base):
    _, jdi, tdi, store = world
    got = proximity_search(store, "ais", _inputs("port")[kind], dist, base_filter=base, device_index=tdi)
    want = jproximity(jdi.store, "ais", _inputs("jax")[kind], dist, base_filter=base, device_index=jdi)
    np.testing.assert_array_equal(got[0].fids, want[0].fids)
    np.testing.assert_array_equal(got[1], want[1])


def test_proximity_multipoint_and_errors(world):
    _, _, tdi, store = world
    mp = MultiPoint((Point(-5.0, -2.0), Point(3.0, 4.0)))
    got = proximity_search(store, "ais", mp, 1.0, device_index=tdi)
    pts = proximity_search(store, "ais", [(-5.0, -2.0), (3.0, 4.0)], 1.0, device_index=tdi)
    np.testing.assert_array_equal(got[0].fids, pts[0].fids)
    np.testing.assert_array_equal(got[1], pts[1])
    with pytest.raises(ValueError, match="no input"):
        proximity_search(store, "ais", [], 1.0, device_index=tdi)


# -- ports of tests/test_process.py TestKnn (the store path there) -----------

@pytest.fixture(scope="module")
def process_rows():
    rng = np.random.default_rng(9)
    n = 30000
    cols = {
        "c": np.arange(n),
        "dtg": T0 + rng.integers(0, 10 * DAY, n),
        "geom": _f32(np.stack([rng.uniform(-10, 10, n), rng.uniform(40, 60, n)], axis=1)),
    }
    return (cols, *_pair(cols))


def test_knn_exact(process_rows):
    cols, _, tdi, store = process_rows
    x, y = cols["geom"][:, 0], cols["geom"][:, 1]
    px, py = 1.5, 50.5
    expected = np.sort(_dist_deg(x, y, px, py))[:10]
    batch, dists = knn(store, "ais", px, py, 10, device_index=tdi)
    assert len(batch) == 10
    np.testing.assert_allclose(np.sort(dists), expected, rtol=1e-6)


def test_exhausted_window_stays_clamped(process_rows):
    _, _, tdi, store = process_rows
    batch, _ = knn(store, "ais", 120.0, -40.0, 10, initial_radius_deg=0.01,
                   max_radius_deg=0.5, device_index=tdi)
    assert len(batch) == 0
    # the window path (a base filter with a host residual) clamps alike
    batch, _ = knn(store, "ais", 120.0, -40.0, 10, base_filter="c < 5 OR dtg IS NULL",
                   initial_radius_deg=0.01, max_radius_deg=0.5, device_index=tdi)
    assert len(batch) == 0


def test_exhausted_window_returns_in_radius_hits(process_rows):
    _, jdi, tdi, store = process_rows
    batch, dists = knn(store, "ais", 1.5, 50.5, 100000, initial_radius_deg=0.01,
                       max_radius_deg=2.0, device_index=tdi)
    assert 0 < len(batch) < 30000
    assert float(dists.max()) <= 2.0 * np.sqrt(2) + 1e-9
    want = jknn(jdi.store, "ais", 1.5, 50.5, 100000, initial_radius_deg=0.01,
                max_radius_deg=2.0, device_index=jdi)
    np.testing.assert_array_equal(batch.fids, want[0].fids)


# -- ports of tests/test_process_more.py (resident against the store path) ---

def test_knn_resident_matches_store_path():
    rng = np.random.default_rng(9)
    n = 3000
    cols = {"c": np.arange(n), "dtg": np.full(n, T0),
            "geom": _f32(np.stack([rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)], axis=1))}
    _, tdi, store = _pair(cols)
    b_store, d_store = jknn(_memory_store(cols), "ais", 2.0, 5.0, k=25)
    b_res, d_res = knn(store, "ais", 2.0, 5.0, k=25, device_index=tdi)
    np.testing.assert_array_equal(b_res.fids, b_store.fids)
    np.testing.assert_allclose(d_res, d_store, rtol=1e-6)


def test_tube_and_proximity_resident_match_store_path(world):
    cols, _, tdi, store = world
    ds = _memory_store(cols)
    m = 13
    track = np.stack([np.linspace(-8, 8, m), np.linspace(-6, 7, m) + 0.5 * np.sin(np.arange(m))], axis=1)
    track_t = T0 + np.linspace(0, DAY, m).astype(np.int64)
    b_store = jtube(ds, "ais", track, track_t, 1.5, 3_600_000)
    b_res = tube_select(store, "ais", track, track_t, 1.5, 3_600_000, device_index=tdi)
    assert len(b_store) > 0
    np.testing.assert_array_equal(np.sort(b_res.fids), np.sort(b_store.fids))
    pts = [(-5.0, -2.0), (3.0, 4.0), (8.0, -8.0)]
    bp_store, dp_store = jproximity(ds, "ais", pts, 1.0)
    bp_res, dp_res = proximity_search(store, "ais", pts, 1.0, device_index=tdi)
    assert len(bp_store) > 0
    np.testing.assert_array_equal(np.sort(bp_res.fids), np.sort(bp_store.fids))
    np.testing.assert_allclose(dp_res[np.argsort(bp_res.fids)], dp_store[np.argsort(bp_store.fids)])


def test_tube_with_base_filter_stays_one_dispatch(monkeypatch):
    """A corridor query with a base filter runs one window-union pass
    (the base's mask from the filter-scan kernel ANDed in) and never asks
    the store; it matches the JAX package's store path."""
    rng = np.random.default_rng(21)
    n = 4000
    cols = {"c": np.arange(n), "dtg": T0 + rng.integers(0, DAY, n),
            "geom": _f32(rng.uniform(-10, 10, (n, 2)))}
    jdi, tdi, store = _pair(cols)
    ds = _memory_store(cols)
    union_calls = []
    orig = DeviceIndex.window_union_query

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        union_calls.append(out is not None)
        return out

    monkeypatch.setattr(DeviceIndex, "window_union_query", spy)
    monkeypatch.setattr(BatchStore, "query", lambda *a, **k: pytest.fail("the store was asked"))
    m = 9
    track = np.stack([np.linspace(-8, 8, m), np.linspace(-6, 7, m)], axis=1)
    track_t = T0 + np.linspace(0, DAY, m).astype(np.int64)
    base = "c < 2000"
    b_store = jtube(ds, "ais", track, track_t, 1.5, 3_600_000, base_filter=base)
    b_res = tube_select(store, "ais", track, track_t, 1.5, 3_600_000, base_filter=base,
                        device_index=tdi)
    assert union_calls == [True]
    assert len(b_res) > 0 and np.all(b_res.column("c") < 2000)
    np.testing.assert_array_equal(np.sort(b_res.fids), np.sort(b_store.fids))
    union_calls.clear()
    pts = [(-5.0, -2.0), (3.0, 4.0)]
    bp_res, _ = proximity_search(store, "ais", pts, 1.0, base_filter=base, device_index=tdi)
    bp_store, _ = jproximity(ds, "ais", pts, 1.0, base_filter=base)
    assert union_calls == [True]
    np.testing.assert_array_equal(np.sort(bp_res.fids), np.sort(bp_store.fids))
    # a base with a host residual cannot fuse: None, as in the JAX package
    union_calls.clear()
    envs = np.array([[-10.0, -10.0, 10.0, 10.0]])
    got = tdi.window_union_query(envs, base="c < 2000 AND dtg IS NULL")
    want = jdi.window_union_query(envs, base="c < 2000 AND dtg IS NULL")
    assert (got is None) == (want is None)
    assert got is None or len(got) == len(want) == 0


# -- the store path ------------------------------------------------------------

def test_filtered_store_path_raises_naming_the_store_item(world):
    """A BatchStore serves no filtered query, in both packages: the store
    paths of the processes raise there (also when an index that cannot
    answer falls through to the store). A MemoryDataStore answers them,
    as the JAX package's does."""
    cols, jdi, tdi, store = world
    jstore = JStore(JBatch.from_columns(JSFT.create("ais", SPEC), cols))
    xy, t = _track(5)
    for pkg_store, kn, tube, prox in ((store, knn, tube_select, proximity_search),
                                      (jstore, jknn, jtube, jproximity)):
        with pytest.raises(NotImplementedError, match="full scans only"):
            kn(pkg_store, "ais", 0.0, 0.0, 5)
        with pytest.raises(NotImplementedError, match="full scans only"):
            tube(pkg_store, "ais", xy, t, 1.0, 3_600_000)
        with pytest.raises(NotImplementedError, match="full scans only"):
            prox(pkg_store, "ais", [(0.0, 0.0)], 1.0)
    base = "c < 5 OR dtg IS NULL"  # a host residual: the index declines
    with pytest.raises(NotImplementedError, match="full scans only"):
        tube_select(store, "ais", xy, t, 1.0, 3_600_000, base_filter=base, device_index=tdi)
    with pytest.raises(NotImplementedError, match="full scans only"):
        jtube(jstore, "ais", xy, t, 1.0, 3_600_000, base_filter=base, device_index=jdi)
    from geomesa_tpu_torch.store.memory import MemoryDataStore as TMemory

    tds = TMemory(partition_size=1024, device="cpu")
    tds.create_schema("ais", SPEC)
    tds.write("ais", {k: v for k, v in cols.items() if k != VIS_COLUMN})
    jds = _memory_store(cols)
    got, gd = knn(tds, "ais", 0.0, 0.0, 5)
    want, wd = jknn(jds, "ais", 0.0, 0.0, 5)
    np.testing.assert_array_equal(got.fids, want.fids)
    np.testing.assert_array_equal(gd, wd)
    got = tube_select(tds, "ais", xy, t, 1.0, 3_600_000, base_filter=base, device_index=tdi)
    want = jtube(jds, "ais", xy, t, 1.0, 3_600_000, base_filter=base, device_index=jdi)
    np.testing.assert_array_equal(got.fids, want.fids)
    got, gd = proximity_search(tds, "ais", [(0.0, 0.0)], 1.0)
    want, wd = jproximity(jds, "ais", [(0.0, 0.0)], 1.0)
    np.testing.assert_array_equal(got.fids, want.fids)
    np.testing.assert_array_equal(gd, wd)