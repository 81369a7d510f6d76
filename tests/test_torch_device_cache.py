"""Port parity for the slice as a whole: ``geomesa_tpu_torch``'s resident
``DeviceIndex`` against ``geomesa_tpu``'s, on the same data.

The same numpy columns go into both packages' ``BatchStore`` and a
``DeviceIndex(z_planes=True)`` (the port's on ``device="cpu"``, where its
kernel wrappers run their plain versions). Coordinates and query bounds
are exact in float32, so the JAX package's float64 planes on the CPU and
the port's float32 planes decide every compare alike. Checked: the staged
key planes, and for bbox+during queries on a Z3 and a Z2 schema the loose
count, the exact count and the query fid sets -- also for an index built
from the JAX package's own planes with ``convert.planes_from_numpy``.
Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.convert import planes_from_numpy
from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY, DeviceIndex
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
Z3_SPEC = "count:Int,dtg:Date,name:String,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,*geom:Point:srid=4326"


def _columns(n, seed, with_dtg=True):
    rng = np.random.default_rng(seed)
    # 90% in a few clusters, the rest uniform; every value exact in float32
    centers = rng.uniform([-170, -80], [170, 80], (8, 2))
    cid = rng.integers(0, 8, n)
    xy = centers[cid] + rng.normal(0, 2.0, (n, 2))
    uni = rng.uniform([-180, -90], [180, 90], (n, 2))
    xy = np.where(rng.uniform(size=(n, 1)) < 0.9, xy, uni)
    xy[:, 0] = np.clip(xy[:, 0], -180, 180)
    xy[:, 1] = np.clip(xy[:, 1], -90, 90)
    xy = xy.astype(np.float32).astype(np.float64)
    xy[:4] = [[-10.0, 35.0], [30.0, 60.0], [180.0, 90.0], [-180.0, -90.0]]
    cols = {"count": rng.integers(0, 1000, n), "geom": xy}
    if with_dtg:
        cols["dtg"] = rng.integers(T0, T0 + 60 * DAY, n)
        cols["dtg"][:2] = [T0 + 9 * DAY, T0 + 14 * DAY]  # on window edges
        cols["name"] = np.array(["a", "b", "c"] * (n // 3) + ["a"] * (n % 3), dtype=object)
    return cols


def _w(d0, d1):
    return f"2020-01-{d0:02d}T00:00:00Z/2020-{d1}Z"


Z3_QUERIES = [
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "BBOX(geom, -180, -90, 180, 90) AND dtg DURING 2020-01-01T00:00:00Z/2020-01-02T00:00:00Z",
    "BBOX(geom, 2.25, 48.5, 2.75, 49) AND dtg DURING 2020-01-05T00:00:00Z/2020-02-02T00:00:00Z",
    "BBOX(geom, -130, 20, -60, 55) AND dtg DURING 2020-02-01T06:30:00Z/2020-02-03T18:00:00Z",
    "BBOX(geom, 100, -50, 160, 0) AND dtg DURING 2020-01-20T00:00:00Z/2020-02-17T00:00:00Z",
    "BBOX(geom, 179.5, 89.5, 180, 90) AND dtg DURING 2019-12-01T00:00:00Z/2020-04-01T00:00:00Z",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2021-01-01T00:00:00Z/2021-02-01T00:00:00Z",
    "BBOX(geom, 10, 10, 5, 5) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "BBOX(geom, -60, -30, 60, 30)",
    "dtg DURING 2020-01-28T00:00:00Z/2020-02-04T12:00:00Z",
    "dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z AND BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z "
    "AND count > 500",
    "BBOX(geom, -10, 35, 30, 60) AND name LIKE 'a%'",
    "INCLUDE",
]
Z2_QUERIES = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -180, -90, 180, 90)",
    "BBOX(geom, 2.25, 48.5, 2.75, 49)",
    "BBOX(geom, 179.5, 89.5, 180, 90)",
    "BBOX(geom, -130, 20, -60, 55) AND count < 100",
    "BBOX(geom, 10, 10, 5, 5)",
]


def _pair(spec, cols):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    jsft, sft = JSFT.create("t", spec), SimpleFeatureType.create("t", spec)
    jdi = JIndex(JStore(JBatch.from_columns(jsft, cols)), "t", z_planes=True)
    batch = FeatureBatch.from_columns(sft, cols)
    tdi = DeviceIndex(BatchStore(batch), "t", z_planes=True, device="cpu")
    return jdi, tdi, sft, batch


@pytest.fixture(scope="module")
def z3():
    return _pair(Z3_SPEC, _columns(20011, seed=1))


@pytest.fixture(scope="module")
def z2():
    return _pair(Z2_SPEC, _columns(20011, seed=2, with_dtg=False))


def _assert_same(jdi, tdi, ecql):
    assert tdi.count(ecql, loose=True) == jdi.count(ecql, loose=True)
    assert tdi.count(ecql, loose=False) == jdi.count(ecql, loose=False)
    for loose in (False, True):
        np.testing.assert_array_equal(
            np.sort(tdi.query(ecql, loose=loose).fids),
            np.sort(jdi.query(ecql, loose=loose).fids),
        )


def test_staged_planes_match(z3, z2):
    for jdi, tdi, _, _ in (z3, z2):
        names = [Z_NX, Z_NY] + ([Z_BT] if tdi._z_kind == "z3" else [])
        assert tdi._z_kind == jdi._z_kind and jdi._dim_mode
        for k in names:
            np.testing.assert_array_equal(tdi._cols[k].numpy(), np.asarray(jdi._cols[k]))
        assert tdi._bt_base == jdi._bt_base and tdi._bin_range == jdi._bin_range


@pytest.mark.parametrize("ecql", Z3_QUERIES, ids=lambda s: s[:50])
def test_z3_counts_and_fids_match(z3, ecql):
    jdi, tdi, _, _ = z3
    _assert_same(jdi, tdi, ecql)


@pytest.mark.parametrize("ecql", Z2_QUERIES)
def test_z2_counts_and_fids_match(z2, ecql):
    jdi, tdi, _, _ = z2
    _assert_same(jdi, tdi, ecql)


@pytest.mark.parametrize("which", ["z3", "z2"])
def test_index_from_jax_planes_answers_identically(z3, z2, which):
    jdi, _, sft, batch = z3 if which == "z3" else z2
    planes = planes_from_numpy(
        {k: np.asarray(v) for k, v in jdi._cols.items()}, "cpu"
    )
    tdi = DeviceIndex.from_planes(
        sft, batch, planes, jdi._bt_base, jdi._bin_range, device="cpu"
    )
    for ecql in (Z3_QUERIES if which == "z3" else Z2_QUERIES)[:6]:
        _assert_same(jdi, tdi, ecql)


def test_main_path_goes_through_the_kernel_wrappers(z3, z2):
    """On CPU tensors the wrappers run the plain versions and count no
    launches; the exact bbox+during path never takes device_fn."""
    _, t3, _, _ = z3
    _, t2, _, _ = z2
    kernels.reset_counts()
    t3.count(Z3_QUERIES[0], loose=True)
    t3.count(Z3_QUERIES[0], loose=False)
    t3.query(Z3_QUERIES[0])
    t2.count(Z2_QUERIES[0], loose=True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels.DEVICE_FN_CALLS == {"count": 0, "mask": 0}


def test_loose_is_superset_of_exact(z3):
    _, tdi, _, _ = z3
    for ecql in Z3_QUERIES[:8]:
        loose = tdi.mask(ecql, loose=True)
        exact = tdi.mask(ecql, loose=False)
        assert not np.any(exact & ~loose)


def test_default_index_answers_loose_like_the_reference():
    """Both packages default to ``z_planes=False``: with no key planes a
    loose count is the exact count in each (the port once defaulted to key
    planes and answered a cell-granular superset instead)."""
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    cols = _columns(5003, seed=7)
    jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("t", Z3_SPEC), cols)), "t")
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("t", Z3_SPEC), cols)
    tdi = DeviceIndex(BatchStore(batch), "t", device="cpu")
    assert tdi._z_kind is None and Z_NX not in tdi._cols
    for ecql in Z3_QUERIES[:4]:
        assert tdi.count(ecql, loose=True) == jdi.count(ecql, loose=True)
        assert tdi.count(ecql, loose=True) == tdi.count(ecql)


def test_later_slices_raise():
    """Named for the slices when each part below raised. A test whose check
    changes keeps its name, so reports of runs line up; each part now
    serves, and each is held to the JAX package's answer."""
    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    sft = SimpleFeatureType.create("t", Z3_SPEC)
    cols = _columns(64, seed=3)
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    # the interleaved key layout is in the port now: it stages and serves
    inter = DeviceIndex(store, "t", z_planes=True, dim_planes=False, device="cpu")
    assert not inter._dim_mode and Z_NX not in inter._cols
    assert inter.count(Z3_QUERIES[0], loose=True) >= inter.count(Z3_QUERIES[0])
    di = DeviceIndex(store, "t", device="cpu")
    # the host sketches are in the port now: a TopK observes the masked
    # host rows, as the JAX package's does
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("t", Z3_SPEC), cols)), "t", z_planes=True)
    for spec in ('TopK("name")', 'Cardinality("count");Frequency("name")'):
        assert di.stats("INCLUDE", spec).to_json() == jdi.stats("INCLUDE", spec).to_json()
    # the base index's refresh_delta restages and says so, as the reference's does
    assert di.refresh_delta(None) == "restage" and len(di) == 64
    # the resident warmup is in the port now: the JAX package's legs, and
    # warmup() answers every one of them (tests/test_torch_warmup.py)
    assert [s for s, _ in di.warmup_plan()] == [s for s, _ in jdi.warmup_plan()]
    got, want = di.warmup(), jdi.warmup()
    assert {k: v is None for k, v in got.items()} == {k: v is None for k, v in want.items()}
    # the DE-9IM relations, non-point schemas, kNN, the fused loose paths,
    # window pairs and BIN output are in the port now: they answer as the
    # JAX package does
    world = np.array([[-180.0, -90.0, 180.0, 90.0], [0.0, 0.0, 0.0, 0.0]])
    for got, want in zip(di.window_pairs_query(world), jdi.window_pairs_query(world)):
        np.testing.assert_array_equal(got, want)
    assert di.bin_export("INCLUDE", "count") == jdi.bin_export("INCLUDE", "count")
    assert di.bin_rider("INCLUDE", "count") == jdi.bin_rider("INCLUDE", "count")
    assert di.fused_loose_counts([Z3_QUERIES[0]]) is jdi.fused_loose_counts([Z3_QUERIES[0]])
    assert inter.fused_loose_counts(Z3_QUERIES[:3], loose=True) == jdi.fused_loose_counts(
        Z3_QUERIES[:3], loose=True)
    np.testing.assert_array_equal(di.knn(0.0, 0.0, 5)[0].fids, jdi.knn(0.0, 0.0, 5)[0].fids)
    for ecql in ("RELATE(geom, POINT(0 0), 'T********')",
                 "TOUCHES(geom, POLYGON((-60 -30, 60 -30, 60 30, -60 30, -60 -30)))",
                 "RELATE(geom, POLYGON((-60 -30, 60 -30, 60 30, -60 30, -60 -30)), 'T********')"):
        assert di.count(ecql) == jdi.count(ecql)
    spec = "*geom:Polygon:srid=4326"
    wkt = ["POLYGON((0 0, 1 0, 1 1, 0 0))", "POLYGON((5 5, 6 5, 6 6, 5 5))"]
    poly = FeatureBatch.from_columns(SimpleFeatureType.create("p", spec), {"geom": wkt})
    jpoly = JBatch.from_columns(JSFT.create("p", spec), {"geom": wkt})
    pdi = DeviceIndex(BatchStore(poly), "p", z_planes=True, device="cpu")
    jpdi = JIndex(JStore(jpoly), "p", z_planes=True)
    assert pdi._z_kind == jpdi._z_kind == "xz2"
    for ecql in ("BBOX(geom, 0.5, 0.5, 2, 2)", "INTERSECTS(geom, POINT(0.75 0.25))"):
        for loose in (False, True):
            assert pdi.count(ecql, loose=loose) == jpdi.count(ecql, loose=loose)


def _edge_cell_pair():
    """The ``query.loose.bbox`` probe's case: 3,000 z3 rows, 2 inside a
    box and 100 at 1e-5 deg west of its west edge, inside the edge's key
    cell (the box's west edge sits mid-cell); the other 2,898 far away.
    Coordinates and bounds float32-exact."""
    from geomesa_tpu_torch.curves.z3 import Z3SFC

    cell = 360.0 / (1 << 21)
    x0 = float(np.float32((int((10.0 + 180.0) / cell) + 0.5) * cell - 180.0))
    west = float(np.float32(x0 - 1e-5))
    sfc = Z3SFC()
    assert int(sfc.lon.normalize(west)) == int(sfc.lon.normalize(x0)) and west < x0
    rng = np.random.default_rng(11)
    n = 3000
    xy = np.stack([rng.uniform(-170, -100, n), rng.uniform(-80, -10, n)], 1)
    xy = xy.astype(np.float32).astype(np.float64)
    xy[:2] = [[x0 + 0.5, 45.0], [x0 + 1.0, 46.0]]
    xy[2:102, 0], xy[2:102, 1] = west, 45.25
    cols = {"count": rng.integers(0, 1000, n), "geom": xy,
            "dtg": np.full(n, T0 + 12 * DAY), "name": np.array(["a"] * n, dtype=object)}
    jdi, tdi, _, _ = _pair(Z3_SPEC, cols)
    q = (f"BBOX(geom, {x0!r}, 44, {x0 + 2.0!r}, 47) AND "
         "dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z")
    return jdi, tdi, q


@pytest.mark.parametrize("prop", [False, True], ids=["off", "on"])
def test_query_loose_bbox_property_resolves_loose_none(prop):
    """With ``loose=None`` both packages read ``query.loose.bbox``, each
    set through its own ``prop_override``: on, every entry point answers
    the key planes' 102 rows, the edge cell's 100 included; off, the exact
    2. The port's scheduler fuses ``loose=None`` requests exactly when the
    property is on."""
    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.sched import FusableQuery

    jdi, tdi, q = _edge_cell_pair()
    want = 102 if prop else 2
    env = Envelope(0.0, 40.0, 20.0, 50.0)
    with conf.prop_override("query.loose.bbox", prop), \
            jconf.prop_override("query.loose.bbox", prop):
        for di in (jdi, tdi):
            assert di.count(q) == want
            assert len(di.query(q)) == want
            assert di.stats(q, "Count()").stats[0].count == want
            assert int(np.asarray(di.density(q, env, 64, 32)).sum()) == want
        assert tdi.fused_loose_counts([q]) == jdi.fused_loose_counts([q]) == (
            [want] if prop else None)
        assert FusableQuery(tdi, q, "count").fusable is prop
    assert tdi.count(q) == jdi.count(q) == 2  # the property's default is off


def test_launch_failpoint_fails_count_mask_and_fused_agg():
    """An armed ``fail.device.launch`` fails the resident count, mask (and
    query, which takes the mask) and the pushdown aggregations (stats,
    density) in both packages, as the reference's chaos runs expect."""
    from geomesa_tpu import failpoints as jfp
    from geomesa_tpu_torch import failpoints as tfp
    from geomesa_tpu_torch.geom import Envelope

    jdi, tdi, q = _edge_cell_pair()
    env = Envelope(0.0, 40.0, 20.0, 50.0)
    calls = (lambda di: di.count(q), lambda di: di.count(q, loose=True),
             lambda di: di.mask(q), lambda di: di.query(q),
             lambda di: di.stats(q, "Count()"), lambda di: di.density(q, env, 8, 8))
    # the reference's hook also takes a cache key before the aggregation
    agg = ((jdi, jfp, lambda f: jdi._fused_agg(f, False, ("count",), lambda cols, m: {})),
           (tdi, tfp, lambda f: tdi._fused_agg(f, False, lambda cols, m: 0)))
    for di, fp, fused_agg in agg:
        with fp.failpoint_override("fail.device.launch", "raise"):
            for call in calls:
                with pytest.raises(fp.FailpointError):
                    call(di)
        with fp.failpoint_override("fail.device.launch", "raise:1"):
            with pytest.raises(fp.FailpointError):
                fused_agg(di._parse(q))
        assert di.count(q) == 2  # disarmed


def test_columns_names_the_staged_planes():
    """``columns=`` stages only the named attribute planes, as in the
    reference: a filter over a plane left out is answered on the host,
    and the answers equal the reference's (streaming index too)."""
    import warnings

    from geomesa_tpu.device_cache import StreamingDeviceIndex as JStream
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.device_cache import StreamingDeviceIndex
    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    cols = _columns(3001, seed=9)
    keep = ["geom__x", "geom__y"]
    jstore = JStore(JBatch.from_columns(JSFT.create("t", Z3_SPEC), cols))
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", Z3_SPEC), cols))
    pairs = [(JIndex(jstore, "t", columns=keep, z_planes=True),
              DeviceIndex(store, "t", columns=keep, z_planes=True, device="cpu")),
             (JStream(jstore, "t", columns=keep, z_planes=True),
              StreamingDeviceIndex(store, "t", columns=keep, z_planes=True, device="cpu"))]
    for jdi, tdi in pairs:
        assert "count" not in tdi._cols and "geom__x" in tdi._cols
        for ecql in (Z3_QUERIES[0], Z3_QUERIES[11], "count > 500", "INCLUDE"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the reference warns of host evaluation
                for loose in (False, True):
                    assert tdi.count(ecql, loose=loose) == jdi.count(ecql, loose=loose), ecql
                np.testing.assert_array_equal(np.sort(tdi.query(ecql).fids),
                                              np.sort(jdi.query(ecql).fids))
