"""Port parity for the store path: ``geomesa_tpu_torch``'s
``MemoryDataStore`` (planner, host index build, runner, post-processing,
audit), ``store/ageoff.py``, ``api.py`` and ``BatchStore`` against
``geomesa_tpu``'s.

The same operations go to a store of each package: z3 points, z2 points
(no date), and xz2/xz3 footprints (polygons). Compared: fids in result
order, counts, scanned rows, ``get_by_ids``, ``delete``, ``age_off``,
``stats()`` JSON, projections, ``sort_by``, ``max_features``, three auth
sets on labeled rows, the GeoTools-shaped surface of ``DataStoreFinder``
and the audit events. The port's stores scan on ``device="cpu"``, where
the filter-scan wrapper runs its plain version.

Coordinates and query constants are float32-exact: the JAX package's CPU
runner stages float64 planes, the port float32, as the JAX package does on
its TPU (ROADMAP section 3, Definitions). Inputs are made from numpy seeds
at up to 2^14 rows in partitions of 2^10. Tolerance: equal.

Failure handling: on the CPU the port's runner halves a run on an OOM
(``fail.stage.oom``) and degrades a failed launch (``fail.device.launch``)
to the host rung as the JAX package's does. On the card neither fault
takes the host rung: both raise (ROADMAP section 3), which a store handed
a CUDA device shows here, since the fault fires before anything reaches
the card.
"""

import numpy as np
import pytest

from geomesa_tpu import failpoints as jfp
from geomesa_tpu.api import DataStoreFinder as JFinder
from geomesa_tpu.audit import MemoryAuditWriter as JAudit
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu.store.direct import BatchStore as JBatchStore
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch import failpoints, kernels, metrics
from geomesa_tpu_torch.api import DataStoreFinder
from geomesa_tpu_torch.audit import MemoryAuditWriter
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.store.direct import BatchStore
from geomesa_tpu_torch.store.memory import MemoryDataStore

T0 = 1_577_836_800_000  # 2020-01-01
DAY = 86_400_000
PSIZE = 1 << 10
Z3_SPEC = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
Z2_SPEC = "name:String,count:Int,*geom:Point:srid=4326"
XZ_SPEC = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"
AUTHS = [None, ("A",), ("A", "B", "C")]


def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _points(n, seed, with_dtg=True, labels=False):
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-150, -60], [150, 60], (16, 2))
    c = centres[rng.integers(0, 16, n)] + rng.normal(0, 3.0, (n, 2))
    cols = {
        "name": np.array(["a", "b", "c", "d"], object)[rng.integers(0, 4, n)],
        "count": rng.integers(0, 1000, n),
        "geom": _f32(np.clip(c, [-180, -90], [180, 90])),
    }
    if with_dtg:
        cols["val"] = np.round(rng.uniform(0, 10, n), 2)
        cols["dtg"] = T0 + rng.integers(0, 60 * DAY, n)
    if labels:
        cols[VIS_COLUMN] = np.array(["", "A", "B", "A&B", "A|C", "(A|B)&C"], object)[
            rng.integers(0, 6, n)]
    return cols


def _footprints(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform([-60, -40], [60, 40], (n, 2))
    w = rng.integers(1, 64, (n, 2)) / 64.0
    xy = np.round(c * 64) / 64  # corners on a 1/64-degree grid: float32-exact
    wkt = [f"POLYGON(({a} {b}, {a + dx} {b}, {a + dx} {b + dy}, {a} {b + dy}, {a} {b}))"
           for a, b, dx, dy in zip(xy[:, 0], xy[:, 1], w[:, 0], w[:, 1])]
    return {
        "name": np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)],
        "count": rng.integers(0, 1000, n),
        "dtg": T0 + rng.integers(0, 60 * DAY, n),
        "geom": wkt,
    }


def _pair(spec, cols, **kw):
    tds = MemoryDataStore(partition_size=PSIZE, device="cpu", **kw)
    jds = JMemory(partition_size=PSIZE, **({"audit_writer": JAudit()} if kw else {}))
    for ds in (tds, jds):
        ds.create_schema("t", spec)
        ds.write("t", cols)
    return tds, jds


def _same(got, want):
    assert got.scanned == want.scanned and got.total == want.total
    assert got.plan.index_name == want.plan.index_name
    np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
    assert sorted(got.batch.columns) == sorted(want.batch.columns)
    for k, v in want.batch.columns.items():
        if v.dtype == object:
            assert [str(a) for a in got.batch.columns[k]] == [str(a) for a in v]
        else:
            np.testing.assert_array_equal(got.batch.columns[k], v)


BOX = "BBOX(geom, -40.5, -20.25, 60.75, 45.5)"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-02-10T00:00:00Z"
Z3_QUERIES = [
    f"{BOX} AND {DURING}",
    BOX,
    DURING,
    "count > 500",
    f"{BOX} AND count < 300 AND name = 'b'",
    f"{BOX} OR BBOX(geom, 100.5, -50, 150, 10)",
    "INTERSECTS(geom, POLYGON((-30 -20, 50 -10, 40 40, -20 30, -30 -20)))",
    "DWITHIN(geom, POINT(10 10), 12.5, degrees)",
    "name LIKE 'a%' AND dtg AFTER 2020-02-01T00:00:00Z",
    "NOT (count BETWEEN 100 AND 900) AND dtg BEFORE 2020-01-20T00:00:00Z",
    "name IN ('a', 'c') AND count >= 990",
    "INCLUDE",
    "EXCLUDE",
    "BBOX(geom, 179.5, 89.5, 180, 90)",
]


@pytest.fixture(scope="module")
def z3():
    return _pair(Z3_SPEC, _points(1 << 14, seed=1))


@pytest.mark.parametrize("ecql", Z3_QUERIES)
def test_z3_queries_equal_the_reference(z3, ecql):
    tds, jds = z3
    _same(tds.query("t", ecql), jds.query("t", ecql))
    assert tds.count("t", ecql) == jds.count("t", ecql)


@pytest.mark.parametrize("ecql", [q for q in Z3_QUERIES if "dtg" not in q])
def test_z2_queries_equal_the_reference(ecql):
    tds, jds = _pair(Z2_SPEC, _points(6007, seed=2, with_dtg=False))
    _same(tds.query("t", ecql), jds.query("t", ecql))


XZ_QUERIES = [
    f"{BOX} AND {DURING}",
    BOX,
    "INTERSECTS(geom, POLYGON((-30 -20, 50 -10, 40 40, -20 30, -30 -20)))",
    "TOUCHES(geom, POLYGON((0 0, 10 0, 10 10, 0 10, 0 0)))",
    "DWITHIN(geom, POINT(10 10), 3.5, degrees) AND count > 200",
    "count < 100",
]


@pytest.mark.parametrize("ecql", XZ_QUERIES)
def test_xz_queries_equal_the_reference(ecql):
    tds, jds = _pair(XZ_SPEC, _footprints(3001, seed=3))
    got, want = tds.query("t", ecql), jds.query("t", ecql)
    assert got.plan.index_name in ("xz3", "xz2", "id")
    _same(got, want)


@pytest.mark.parametrize("q", [
    dict(sort_by="count"), dict(sort_by="dtg", sort_desc=True), dict(max_features=17),
    dict(properties=["count", "geom"]), dict(sort_by="count", max_features=5, properties=["name"]),
], ids=["sort", "sort-desc", "max", "properties", "all"])
def test_query_options_equal_the_reference(z3, q):
    tds, jds = z3
    f = f"{BOX} AND {DURING}"
    _same(tds.query("t", Query(filter=f, **q)), jds.query("t", JQuery(filter=f, **q)))


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
def test_labeled_rows_under_auths_equal_the_reference(auths):
    tds, jds = _pair(Z3_SPEC, _points(5003, seed=4, labels=True))
    for f in (f"{BOX} AND {DURING}", "INCLUDE", "count > 400"):
        got = tds.query("t", Query(filter=f, hints={"auths": auths}))
        want = jds.query("t", JQuery(filter=f, hints={"auths": auths}))
        _same(got, want)
        # raw_visibility keeps every labeled row
        raw = tds.query("t", Query(filter=f, hints={"raw_visibility": True}))
        assert len(raw) >= len(got)


def test_writes_deletes_age_off_and_ids_equal_the_reference():
    cols = _points(4001, seed=5)
    tds, jds = _pair(Z3_SPEC, cols)
    more = _points(999, seed=6)
    fids = np.arange(10_000, 10_999)
    tds.write("t", more, fids=fids)
    jds.write("t", more, fids=fids)
    _same(tds.query("t", f"{BOX} AND {DURING}"), jds.query("t", f"{BOX} AND {DURING}"))
    want_ids = [3, 17, 10_005, 99_999, 4000]
    np.testing.assert_array_equal(tds.get_by_ids("t", want_ids).fids, jds.get_by_ids("t", want_ids).fids)
    drop = list(range(0, 4001, 3)) + [10_010]
    assert tds.delete("t", drop) == jds.delete("t", drop)
    _same(tds.query("t", BOX), jds.query("t", BOX))
    cut = T0 + 20 * DAY
    assert tds.age_off("t", cut) == jds.age_off("t", cut) > 0
    _same(tds.query("t", "INCLUDE"), jds.query("t", "INCLUDE"))
    assert tds.stats("t").to_json() == jds.stats("t").to_json()
    assert tds._state("t").data_interval == jds._state("t").data_interval


def test_stats_json_and_schema_surface_equal_the_reference(z3):
    tds, jds = z3
    assert tds.stats("t").to_json() == jds.stats("t").to_json()
    spec = "name:String:index=true,count:Int,dtg:Date,*geom:Point:srid=4326"
    t2, j2 = _pair(spec, {k: v for k, v in _points(2000, seed=7).items() if k != "val"})
    assert t2.stats("t").to_json() == j2.stats("t").to_json()
    _same(t2.query("t", "name = 'b' AND count > 900"), j2.query("t", "name = 'b' AND count > 900"))
    assert t2.type_names == j2.type_names == ["t"]
    with pytest.raises(ValueError, match="exists"):
        t2.create_schema("t", spec)
    with pytest.raises(KeyError, match="no schema"):
        t2.query("nope")
    empty = MemoryDataStore(device="cpu")
    empty.create_schema("e", spec)
    assert len(empty.query("e", BOX)) == 0
    assert empty.stats("e").to_json() == (lambda j: (j.create_schema("e", spec), j.stats("e"))[1])(
        JMemory()).to_json()
    with pytest.raises(ValueError, match="no data"):
        empty.get_by_ids("e", [1])
    t2.remove_schema("t")
    assert t2.type_names == []


def test_runs_merge_partitions_into_launches_of_at_most_eight(z3, monkeypatch):
    from geomesa_tpu_torch.query import runner

    tds, _ = z3
    spans = []
    real = runner._scan_run

    def spy(built, compiled, device, start, stop, depth=0):
        spans.append((start, stop))
        return real(built, compiled, device, start, stop, depth)

    monkeypatch.setattr(runner, "_scan_run", spy)
    res = tds.query("t", "count > 500")  # full table: 16 partitions
    assert res.scanned == 1 << 14
    assert spans == [(0, 8 * PSIZE), (8 * PSIZE, 16 * PSIZE)]
    assert not any(kernels.LAUNCHES.values())  # the CPU runs the plain version


def _degrade_pair(degrade: bool):
    """Both packages' ``resilience.degrade`` switched the same way."""
    from contextlib import ExitStack

    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf

    st = ExitStack()
    st.enter_context(conf.prop_override("resilience.degrade", degrade))
    st.enter_context(jconf.prop_override("resilience.degrade", degrade))
    return st


def _collected(resilience_mod, fn):
    """``fn()`` under a degradation collector: (answer, reasons)."""
    with resilience_mod.collect_degraded() as reasons:
        out = fn()
    return out, list(reasons)


def test_device_launch_failure_raises_through_the_store(z3):
    """A failed launch: under ``resilience.degrade`` both packages answer
    from the host rung, stamped ``device-launch-failed``; with it off,
    both raise."""
    from geomesa_tpu import resilience as jres
    from geomesa_tpu_torch import resilience

    tds, jds = z3
    f = f"{BOX} AND {DURING}"
    with failpoints.failpoint_override("fail.device.launch", "raise"):
        got, reasons = _collected(resilience, lambda: tds.query("t", f))
    with jfp.failpoint_override("fail.device.launch", "raise"):
        want, jreasons = _collected(jres, lambda: jds.query("t", f))
    _same(got, want)
    assert reasons == jreasons == ["device-launch-failed"]
    with _degrade_pair(False):
        with failpoints.failpoint_override("fail.device.launch", "raise"):
            with pytest.raises(failpoints.FailpointError, match="fail.device.launch"):
                tds.query("t", f)
        with jfp.failpoint_override("fail.device.launch", "raise"):
            with pytest.raises(jfp.FailpointError, match="fail.device.launch"):
                jds.query("t", f)


def test_stage_oom_halves_the_run_and_answers_equal(z3):
    from geomesa_tpu import resilience as jres
    from geomesa_tpu_torch import resilience

    tds, jds = z3
    f = "count > 500"
    want = jds.query("t", f)
    before = metrics.resilience_oom_recoveries.value()
    with failpoints.failpoint_override("fail.stage.oom", "raise:3"):
        got = tds.query("t", f)
    assert metrics.resilience_oom_recoveries.value() - before == 3
    _same(got, want)
    # a run of one row cannot halve: under resilience.degrade both packages
    # answer it on the host, stamped device-oom; with it off, both raise
    cols = _points(1, seed=8)
    t1, j1 = _pair(Z3_SPEC, cols)
    with failpoints.failpoint_override("fail.stage.oom", "raise"):
        got, reasons = _collected(resilience, lambda: t1.query("t", "count >= 0"))
    with jfp.failpoint_override("fail.stage.oom", "raise"):
        want, jreasons = _collected(jres, lambda: j1.query("t", "count >= 0"))
    _same(got, want)
    assert reasons == jreasons == ["device-oom"]
    with _degrade_pair(False):
        with failpoints.failpoint_override("fail.stage.oom", "raise"):
            with pytest.raises(failpoints.FailpointError):
                t1.query("t", "count >= 0")
        with jfp.failpoint_override("fail.stage.oom", "raise"):
            with pytest.raises(jfp.FailpointError):
                j1.query("t", "count >= 0")


@pytest.mark.parametrize("point", ["fail.device.launch", "fail.stage.oom"])
def test_a_failed_run_on_the_card_raises_instead_of_taking_the_host_rung(point, monkeypatch):
    """Under ``resilience.degrade``, a failed launch and an OOM on a run of
    one row (which cannot halve) raise through a store on the card and
    note no degradation: no answer of the card's store comes from the
    host."""
    import torch

    from geomesa_tpu_torch import device, resilience

    t1, _ = _pair(Z3_SPEC, _points(1, seed=8))
    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cuda:0"))
    with failpoints.failpoint_override(point, "raise"), resilience.collect_degraded() as reasons:
        with pytest.raises(failpoints.FailpointError, match=point):
            t1.query("t", "count >= 0")
    assert list(reasons) == []


def test_audit_events_equal_the_reference():
    tds, jds = _pair(Z3_SPEC, _points(2000, seed=9), audit_writer=MemoryAuditWriter())
    for f in (BOX, "count > 10"):
        tds.query("t", f)
        jds.query("t", f)
    for ds in (tds, jds):
        ds.audit_writer.close()
    got = [(e.store, e.type_name, e.filter, e.hits) for e in tds.audit_writer.events]
    want = [(e.store, e.type_name, e.filter, e.hits) for e in jds.audit_writer.events]
    assert got == want and len(got) == 2
    assert metrics.queries_run.value(store="memory", type="t") >= 2


def test_data_store_finder_surface_equals_the_reference(tmp_path):
    cols = _points(3001, seed=10)
    ds = DataStoreFinder.get_data_store({"memory": "true", "device": "cpu"})
    jds = JFinder.get_data_store({"memory": "true"})
    for d in (ds, jds):
        d.create_schema("t", Z3_SPEC)
        d.write("t", cols)
    assert ds.get_type_names() == jds.get_type_names() == ["t"]
    src, jsrc = ds.get_feature_source("t"), jds.get_feature_source("t")
    f = f"{BOX} AND {DURING}"
    assert src.get_count(f) == jsrc.get_count(f) > 0
    got, want = src.get_features(f), jsrc.get_features(f)
    assert [g.fid for g in got] == [w.fid for w in want]
    assert [g["count"] for g in got] == [w["count"] for w in want]
    assert src.get_bounds(f) == src.get_features(f).bounds()
    e, je = src.get_bounds(f), jsrc.get_bounds(f)
    assert (e.xmin, e.ymin, e.xmax, e.ymax) == (je.xmin, je.ymin, je.xmax, je.ymax)
    assert src.get_bounds("EXCLUDE") is None
    assert src.get_schema().type_name == "t"
    with pytest.raises(KeyError):
        ds.get_feature_source("nope")
    # the file-system store is in the port; the key-value and lambda
    # stores are not yet
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    fs = DataStoreFinder.get_data_store({"fs.path": str(tmp_path / "fs"), "device": "cpu"})
    assert isinstance(fs._store, FileSystemDataStore) and fs.get_type_names() == []
    for params, what in (({"kv.catalog": "g"}, "key-value store"),
                         ({"lambda.persistent": {}, "lambda.type": "t"}, "lambda store")):
        with pytest.raises(NotImplementedError, match=what):
            DataStoreFinder.get_data_store(params)
    with pytest.raises(ValueError, match="no data store factory"):
        DataStoreFinder.get_data_store({"memory": "false"})


def test_batch_store_refuses_filters_in_both_packages():
    cols = _points(100, seed=11, labels=True)
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", Z3_SPEC), cols))
    jstore = JBatchStore(JBatch.from_columns(JSFT.create("t", Z3_SPEC), cols))
    for s, q in ((store, Query(filter=BOX)), (jstore, JQuery(filter=BOX))):
        with pytest.raises(NotImplementedError, match="full scans only"):
            s.query("t", q)
        with pytest.raises(NotImplementedError, match="full scans only"):
            s.query("t", BOX)
    for auths in AUTHS:
        got = store.query("t", Query(hints={"auths": auths}))
        want = jstore.query("t", JQuery(hints={"auths": auths}))
        np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
        assert got.plan is None and got.total == 100
