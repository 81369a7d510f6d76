"""Port parity for resident kNN: ``geomesa_tpu_torch``'s
``DeviceIndex.knn``, ``ops/knn.py`` and ``process/knn.py`` against
``geomesa_tpu``'s, as ``tests/test_knn_resident.py`` runs the JAX package.

The same numpy columns (float32-exact coordinates) go into both packages'
``BatchStore`` and a ``DeviceIndex`` (the port's on ``device="cpu"``), so
both hold the same rows in the same order; the JAX index's coordinate
planes are float32, as it stages them on its TPU. Tolerances: fids equal, in the
same order; distances within rtol 1e-6 of the JAX package's, whose float32
``cos`` of the target's latitude differs from the port's longitude factor
in the last bit for about a third of latitudes; bit-exact where
``ops/knn.py`` is fed the JAX package's own factor. Not ported:
``test_streaming_eviction_respected`` (the port has no
``StreamingDeviceIndex`` yet).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.process.knn import knn as jknn
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.ops import knn as knn_ops
from geomesa_tpu_torch.process.knn import _dist_deg, knn
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

T0 = 1_577_836_800_000
SPEC = "val:Int,dtg:Date,*geom:Point:srid=4326"


def _cols(n=4000, seed=3, lon=(-180, 180), lat=(-90, 90)):
    rng = np.random.default_rng(seed)
    return {
        "val": rng.integers(0, 100, n),
        "dtg": rng.integers(T0, T0 + 30 * 86_400_000, n),
        "geom": np.stack([rng.uniform(*lon, n), rng.uniform(*lat, n)], axis=1)
        .astype(np.float32).astype(np.float64),
    }


def f32_planes(jdi):
    """The JAX index with float32 coordinate planes, as it stages them on
    its TPU (on the CPU under x64 it keeps float64 and computes float64
    distances); the port always stages float32."""
    for c in ("geom__x", "geom__y"):
        jdi._cols[c] = jnp.asarray(np.asarray(jdi._cols[c]).astype(np.float32))
    return jdi


def _pair(cols, spec=SPEC):
    """(JAX index, port index, port store) over the same rows."""
    jstore = JStore(JBatch.from_columns(JSFT.create("ais", spec), cols))
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("ais", spec), cols))
    return f32_planes(JIndex(jstore, "ais")), DeviceIndex(store, "ais", device="cpu"), store


@pytest.fixture(scope="module")
def world():
    cols = _cols()
    return (cols, *_pair(cols))


def _same(got, want):
    (gb, gd), (wb, wd) = got, want
    np.testing.assert_array_equal(gb.fids, wb.fids)
    np.testing.assert_allclose(gd, wd, rtol=1e-6)


def _oracle(cols, px, py, k, keep=None, max_r=45.0):
    """Host float32 oracle with the same metric and caps (the reference
    test's), stable argsort over the candidate rows."""
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    box = (np.abs(x - np.float32(px)) <= max_r) & (np.abs(y - np.float32(py)) <= max_r)
    if keep is not None:
        box &= keep
    d = _dist_deg(x, y, np.float32(px), np.float32(py))
    idx = np.nonzero(box)[0]
    return idx[np.argsort(d[idx], kind="stable")[:k]]


TARGETS = [(2.0, 48.0), (0.0, 0.0), (-120.5, 35.25), (179.97, -10.0), (10.0, 75.0), (-60.0, -80.0)]


@pytest.mark.parametrize("k", [1, 10, 50, 1000])
@pytest.mark.parametrize("target", TARGETS, ids=repr)
def test_one_dispatch_matches_oracle(world, target, k):
    cols, jdi, tdi, _ = world
    got = tdi.knn(*target, k)
    _same(got, jdi.knn(*target, k))
    np.testing.assert_array_equal(got[0].fids, _oracle(cols, *target, k))


def test_process_routes_to_resident_one_dispatch(world, monkeypatch):
    """knn(..., device_index=) answers via one DeviceIndex.knn call and
    never probes a window."""
    _, _, tdi, store = world
    calls = []
    orig = DeviceIndex.knn

    def spy(self, *a, **kw):
        calls.append(a)
        return orig(self, *a, **kw)

    monkeypatch.setattr(DeviceIndex, "knn", spy)
    monkeypatch.setattr(DeviceIndex, "bbox_window_query",
                        lambda *a, **k: pytest.fail("expanding window probed"))
    batch, _ = knn(store, "ais", 2.0, 48.0, k=10, device_index=tdi)
    assert len(calls) == 1 and len(batch) == 10


def test_tie_at_kth_distance_prefers_earlier_row():
    """Exact duplicate points at the k-th distance: the earlier row wins,
    as the JAX package's lax.top_k keeps it; torch.topk's own order among
    equal values is not that rule."""
    pts = np.array([[0.0, 0.0], [0.1, 0.0], [1.0, 0.0], [1.0, 0.0], [1.0, 0.0]])
    cols = {"val": np.arange(5), "dtg": np.full(5, T0), "geom": pts}
    jdi, tdi, _ = _pair(cols)
    for k in (3, 4):
        batch, _ = tdi.knn(0.0, 0.0, k)
        assert list(batch.column("val")) == list(range(k))
        np.testing.assert_array_equal(batch.fids, jdi.knn(0.0, 0.0, k)[0].fids)
    keys = torch.tensor([1.0, 0.0, 0.0, 0.0, 2.0, 0.0])
    idx, d2 = knn_ops.knn_select(keys, 3)
    assert idx.tolist() == [1, 2, 3] and d2.tolist() == [0.0, 0.0, 0.0]
    # the library call alone picks the same distances but not in row order
    # (torch's CPU topk gives [3, 5, 2] on these keys)
    lib = torch.topk(-keys, 3).indices.tolist()
    assert keys[lib].tolist() == [0.0, 0.0, 0.0] and lib != [1, 2, 3]


def test_k_exceeding_rows_returns_all():
    cols = _cols(n=7)
    jdi, tdi, _ = _pair(cols)
    batch, d = tdi.knn(0.0, 0.0, 100, max_radius_deg=360.0)
    assert len(batch) == 7 and np.all(np.diff(d) >= 0)
    _same((batch, d), jdi.knn(0.0, 0.0, 100, max_radius_deg=360.0))
    for k in (0, -3):
        b0, d0 = tdi.knn(0.0, 0.0, k)
        assert len(b0) == 0 and d0.dtype == np.float64 and len(d0) == 0


def test_max_radius_box_excludes_far_rows():
    cols = _cols(n=500, seed=5, lon=(-20, 20), lat=(-20, 20))
    jdi, tdi, _ = _pair(cols)
    batch, d = tdi.knn(0.0, 0.0, 500, max_radius_deg=5.0)
    x, y = batch.point_coords("geom")
    assert 0 < len(batch) < 500
    assert np.all(np.abs(x) <= 5.0) and np.all(np.abs(y) <= 5.0)
    np.testing.assert_array_equal(batch.fids, _oracle(cols, 0.0, 0.0, 500, max_r=5.0))
    _same((batch, d), jdi.knn(0.0, 0.0, 500, max_radius_deg=5.0))


def test_radius_box_edges_one_ulp():
    """Rows on the box's edge, and one float32 ulp inside and outside it,
    on both axes: the float32 compare keeps the edge and the inside."""
    r, px, py = 0.5, 10.0, 20.0
    edge = [px + r, px - r, py + r, py - r]
    vals = []
    for e in edge:
        e32 = np.float32(e)
        vals.append((e32, np.nextafter(e32, np.float32(np.inf)),
                     np.nextafter(e32, np.float32(-np.inf))))
    pts = []
    for i, trio in enumerate(vals):
        for v in trio:
            pts.append([float(v), py] if i < 2 else [px, float(v)])
    pts = np.array(pts)
    cols = {"val": np.arange(len(pts)), "dtg": np.full(len(pts), T0), "geom": pts}
    jdi, tdi, _ = _pair(cols)
    got = tdi.knn(px, py, 100, max_radius_deg=r)
    _same(got, jdi.knn(px, py, 100, max_radius_deg=r))
    # per side: the edge and the ulp inside stay, the ulp outside goes
    assert len(got[0]) == 8
    np.testing.assert_array_equal(np.sort(got[0].fids), np.sort(_oracle(cols, px, py, 100, max_r=r)))


def test_base_filter_applies_on_device(world):
    cols, jdi, tdi, store = world
    batch, d = tdi.knn(10.0, 20.0, 25, query="val < 50")
    assert len(batch) == 25 and np.all(batch.column("val") < 50)
    _same((batch, d), jdi.knn(10.0, 20.0, 25, query="val < 50"))
    np.testing.assert_array_equal(batch.fids, _oracle(cols, 10.0, 20.0, 25, keep=cols["val"] < 50))
    b2, _ = knn(store, "ais", 10.0, 20.0, k=25, base_filter="val < 50", device_index=tdi)
    np.testing.assert_array_equal(b2.fids, batch.fids)
    # INCLUDE is no filter, as in the JAX package
    np.testing.assert_array_equal(tdi.knn(10.0, 20.0, 5, query="INCLUDE")[0].fids,
                                  tdi.knn(10.0, 20.0, 5)[0].fids)


def test_host_residual_filter_falls_back_to_windows():
    """A filter with a host residual cannot run on the device: knn returns
    None, and the process answers through its expanding windows -- the
    JAX package's answer."""
    n = 200
    rng = np.random.default_rng(0)
    cols = {
        "name": np.array(["ship-%d" % i for i in range(n)], object),
        "dtg": np.full(n, T0),
        "geom": np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)], axis=1)
        .astype(np.float32).astype(np.float64),
    }
    spec = "name:String,dtg:Date,*geom:Point:srid=4326"
    jdi, tdi, store = _pair(cols, spec)
    f = "name LIKE 'ship-1%'"
    assert tdi.knn(0.0, 0.0, 5, query=f) is None
    batch, d = knn(store, "ais", 0.0, 0.0, k=5, base_filter=f, device_index=tdi)
    want = jknn(jdi.store, "ais", 0.0, 0.0, k=5, base_filter=f, device_index=jdi)
    assert len(batch) == 5
    assert all(str(v).startswith("ship-1") for v in batch.column("name"))
    np.testing.assert_array_equal(batch.fids, want[0].fids)
    np.testing.assert_allclose(d, want[1], rtol=1e-12)


@pytest.mark.parametrize("auths", [None, (), ("secret",)], ids=repr)
def test_auths_fail_closed_on_resident_knn(auths):
    n = 300
    rng = np.random.default_rng(1)
    cols = {
        "val": rng.integers(0, 9, n),
        "dtg": np.full(n, T0),
        "geom": np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)], axis=1)
        .astype(np.float32).astype(np.float64),
        VIS_COLUMN: np.array(["", "secret"], object)[rng.integers(0, 2, n)],
    }
    jdi, tdi, store = _pair(cols)
    got = tdi.knn(0.0, 0.0, n, auths=auths)
    labeled = int((cols[VIS_COLUMN] != "").sum())
    assert len(got[0]) == (n if auths else n - labeled)  # fail closed
    _same(got, jdi.knn(0.0, 0.0, n, auths=auths))
    # a base filter and the auth verdict together
    _same(tdi.knn(0.0, 0.0, 40, query="val > 3", auths=auths),
          jdi.knn(0.0, 0.0, 40, query="val > 3", auths=auths))
    b, _ = knn(store, "ais", 0.0, 0.0, k=n, device_index=tdi, auths=auths)
    np.testing.assert_array_equal(b.fids, got[0].fids)


def test_empty_index():
    cols = {"val": np.zeros(0, np.int64), "dtg": np.zeros(0, np.int64), "geom": np.zeros((0, 2))}
    _, tdi, _ = _pair(cols)
    batch, d = tdi.knn(0.0, 0.0, 5)
    assert len(batch) == 0 and len(d) == 0 and d.dtype == np.float64
    assert len(tdi.knn(0.0, 0.0, 5, query="val > 1")[0]) == 0


def test_non_point_schema_returns_none():
    spec = "name:String,*geom:Polygon:srid=4326"
    wkt = ["POLYGON((0 0, 1 0, 1 1, 0 0))", "POLYGON((5 5, 6 5, 6 6, 5 5))"]
    tdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(
        SimpleFeatureType.create("p", spec), {"name": ["a", "b"], "geom": wkt})), "p", device="cpu")
    assert tdi.knn(0.0, 0.0, 1) is None


def test_nan_coordinates_drop_as_in_the_reference():
    """A row with a NaN coordinate is never inside the radius box (a NaN
    compare is false), in both packages, even at an infinite radius."""
    cols = _cols(n=300, seed=11)
    cols["geom"][:5, 0] = np.nan
    cols["geom"][5:9, 1] = np.nan
    jdi, tdi, _ = _pair(cols)
    for r in (45.0, 400.0, float("inf")):
        got = tdi.knn(0.0, 0.0, 300, max_radius_deg=r)
        assert not set(range(9)) & set(got[0].fids.tolist())
        _same(got, jdi.knn(0.0, 0.0, 300, max_radius_deg=r))


def _jax_factor(py):
    return float(np.float32(jnp.cos(jnp.radians(jnp.float32(py)))))


def test_d2_equals_the_reference_fused_form():
    """With the JAX package's own longitude factor, ops/knn.py gives the
    reference's fused d2 (its jitted kNN function over every row) and its
    selection, bit for bit, on 2^16 rows and 8 targets."""
    n = 1 << 16
    cols = _cols(n=n, seed=21)
    jdi, tdi, _ = _pair(cols)
    x, y = tdi._cols["geom__x"], tdi._cols["geom__y"]
    rng = np.random.default_rng(22)
    for _ in range(8):
        px, py = float(rng.uniform(-180, 180)), float(rng.uniform(-89, 89))
        jb, jd = jdi.knn(px, py, n, max_radius_deg=400.0)
        fn = next(v for k, v in jdi._knn_jits.items() if k[2] == n)
        sub = {c: jdi._cols[c] for c in ("geom__x", "geom__y")}  # float32
        rd2, ridx = fn(sub, jnp.asarray(np.array([px, py, 400.0], np.float32)), None, None)
        q = knn_ops.query_vector(px, py, 400.0, _jax_factor(py), "cpu")
        np.testing.assert_array_equal(knn_ops.knn_d2(x, y, q).numpy()[np.asarray(ridx)], np.asarray(rd2))
        idx, d2 = knn_ops.knn(x, y, q, n)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(rd2))
        # the port's own factor: the same rows and distances to rtol 1e-6;
        # over all 2^16 rows, pairs whose distances differ by about an ulp
        # may swap places, since the two factors differ in the last bit
        pb, pd = tdi.knn(px, py, n, max_radius_deg=400.0)
        np.testing.assert_array_equal(np.sort(pb.fids), np.sort(jb.fids))
        np.testing.assert_allclose(pd, jd, rtol=1e-6)


def test_lon_factor_is_rounded_once():
    for py in (0.0, 45.0, -33.3, 75.0, 89.99, 90.0, -90.0):
        c = knn_ops.lon_factor(py)
        assert c == float(np.float32(np.cos(np.radians(np.float64(np.float32(py))))))
