"""Port parity for the store planner: ``geomesa_tpu_torch``'s
``filter/extract.py``, ``index/keyspaces.py``, ``index/build.py``,
``query/plan.py`` and ``query/interceptor.py`` against ``geomesa_tpu``'s.

The same ECQL goes to both packages: the extracted bounds, every key
space's ``supports``/``cost``/``scan_ranges``, and whole plans (the chosen
index, every candidate and its cost with and without the write-time
stats, the ranges, the device/residual split and ``explain()``) must be
equal. The filters are drawn from a seed like ROADMAP section 3's probe:
BBOX, DURING, BEFORE/AFTER, comparisons, BETWEEN, IN, LIKE, IS NULL,
INTERSECTS, DWITHIN and INCLUDE/EXCLUDE under AND/OR/NOT to depth 2.
Coordinates and query constants are float32-exact. Tolerance: equal.
"""

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.filter.ecql import parse_ecql as jparse
from geomesa_tpu.filter.extract import extract_geometries as jgeoms
from geomesa_tpu.filter.extract import extract_intervals as jivals
from geomesa_tpu.index import build as jbuild
from geomesa_tpu.index.keyspaces import default_indices as jdefaults
from geomesa_tpu.index.keyspaces import keyspace_for as jkeyspace
from geomesa_tpu.query import interceptor as jic
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.filter.extract import extract_geometries, extract_intervals
from geomesa_tpu_torch.index import build
from geomesa_tpu_torch.index.keyspaces import default_indices, keyspace_for
from geomesa_tpu_torch.query import interceptor
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.store.memory import MemoryDataStore

T0 = 1_577_836_800_000  # 2020-01-01
DAY = 86_400_000
POINT_SPEC = "name:String:index=true,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
POLY_SPEC = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"


def _iso(ms):
    return np.datetime_as_string(np.datetime64(int(ms), "ms"), unit="s") + "Z"


def _box(rng):
    cx, cy = rng.integers(-160, 160) / 4, rng.integers(-80, 80) / 4
    hx, hy = rng.integers(1, 120) / 8, rng.integers(1, 80) / 8
    return cx - hx, cy - hy, cx + hx, cy + hy


def _leaf(rng):
    k = int(rng.integers(0, 13))
    x0, y0, x1, y1 = _box(rng)
    t0 = T0 + int(rng.integers(-3, 50)) * DAY // 2
    t1 = t0 + int(rng.integers(0, 20)) * DAY // 4
    return [
        f"BBOX(geom, {x0}, {y0}, {x1}, {y1})",
        f"dtg DURING {_iso(t0)}/{_iso(t1)}",
        f"dtg BEFORE {_iso(t1)}",
        f"dtg AFTER {_iso(t0)}",
        f"count {['<', '<=', '>', '>=', '=', '<>'][int(rng.integers(0, 6))]} {int(rng.integers(0, 1000))}",
        f"count BETWEEN {int(rng.integers(0, 400))} AND {int(rng.integers(400, 1000))}",
        f"name IN ('a', 'c', '{['b', 'zz'][int(rng.integers(0, 2))]}')",
        f"name LIKE '{['a%', '_b', 'c'][int(rng.integers(0, 3))]}'",
        "name IS NULL",
        f"INTERSECTS(geom, POLYGON(({x0} {y0}, {x1} {y0}, {x1} {y1}, {x0} {y0})))",
        f"DWITHIN(geom, POINT({x0} {y0}), {int(rng.integers(1, 40)) / 4}, degrees)",
        ["INCLUDE", "EXCLUDE"][int(rng.integers(0, 2))],
        f"name = '{['a', 'b', 'q'][int(rng.integers(0, 3))]}'",
    ][k]


def _filter(rng, depth=2):
    if depth == 0 or rng.random() < 0.35:
        return _leaf(rng)
    op = ["AND", "OR", "NOT"][int(rng.integers(0, 3))]
    if op == "NOT":
        return f"NOT ({_filter(rng, depth - 1)})"
    k = int(rng.integers(2, 4))
    return "(" + f" {op} ".join(_filter(rng, depth - 1) for _ in range(k)) + ")"


ECQL = [_filter(np.random.default_rng(s)) for s in range(48)] + [
    "INCLUDE",
    "EXCLUDE",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-05T00:00:00Z/2020-01-10T00:00:00Z",
    "BBOX(geom, -10, 35, 30, 60) OR BBOX(geom, 100, -40, 150, 0)",
    "(BBOX(geom, -10, 35, 30, 60) OR BBOX(geom, 100, -40, 150, 0)) AND dtg DURING "
    "2020-01-05T00:00:00Z/2020-03-10T00:00:00Z",
    "dtg DURING 2019-12-01T00:00:00Z/2021-06-01T00:00:00Z",
    "name = 'a'",
    "name IN ('a', 'b') AND count > 10",
    "count > 500",
    "BBOX(geom, 179.5, 89.5, 180, 90)",
    "RELATE(geom, POINT(0 0), 'T********')",
]


def _norm_geoms(fb):
    vals = tuple(((e.xmin, e.ymin, e.xmax, e.ymax), None if g is None else type(g).__name__)
                 for e, g in fb.values)
    return fb.unbounded, vals


def _norm_ranges(rs):
    return None if rs is None else [(r.lo, r.hi, r.contained) for r in rs]


@pytest.mark.parametrize("ecql", ECQL)
def test_extracted_bounds_equal_the_reference(ecql):
    f, jf = parse_ecql(ecql), jparse(ecql)
    assert _norm_geoms(extract_geometries(f, "geom")) == _norm_geoms(jgeoms(jf, "geom"))
    for attr in ("dtg", "count"):
        got, want = extract_intervals(f, attr), jivals(jf, attr)
        assert (got.unbounded, got.values, got.empty) == (want.unbounded, want.values, want.empty)


def _walks_open_bins(ks, ivals, data_interval) -> bool:
    """True where the JAX package's key space would enumerate the bins of
    an open interval: a time key space, a bounded filter interval with an
    end at NEG_INF/POS_INF, not clipped (xz3 never clips; z3 clips to a
    data interval when it has one)."""
    from geomesa_tpu_torch.filter.extract import NEG_INF, POS_INF

    if ks.name not in ("z3", "xz3") or ivals.unbounded or not ivals.values:
        return False
    lo = min(v[0] for v in ivals.values)
    hi = max(v[1] for v in ivals.values)
    return (lo <= NEG_INF or hi >= POS_INF) and (ks.name == "xz3" or data_interval is None)


@pytest.mark.parametrize("spec", [POINT_SPEC, POLY_SPEC, "count:Int,*geom:Point:srid=4326",
                                  POINT_SPEC + ";geomesa.z3.interval=day"],
                         ids=["z3", "xz", "z2", "z3-day"])
def test_key_spaces_equal_the_reference(spec):
    sft, jsft = SimpleFeatureType.create("t", spec), JSFT.create("t", spec)
    names = default_indices(sft)
    assert names == jdefaults(jsft)
    interval = (T0 - 5 * DAY, T0 + 70 * DAY)
    for name in names + (["attr:count"] if "count" in sft.attribute_names else []):
        ks, jks = keyspace_for(sft, name), jkeyspace(jsft, name)
        assert ks.key_columns == jks.key_columns and ks.name == jks.name
        for ecql in ECQL[::3]:
            f, jf = parse_ecql(ecql), jparse(ecql)
            g, i = extract_geometries(f, "geom"), extract_intervals(f, "dtg")
            jg, ji = jgeoms(jf, "geom"), jivals(jf, "dtg")
            assert ks.supports(g, i) == jks.supports(jg, ji)
            assert ks.cost(g, i) == jks.cost(jg, ji)
            for budget in (16, 2000):
                for data_interval in (None, interval):
                    if _walks_open_bins(ks, i, data_interval):
                        # the JAX package enumerates bins from -2^62 ms here
                        # (ROADMAP section 3): the port scans the full table
                        # or clips to the data's interval
                        got = ks.scan_ranges(g, i, budget, data_interval=data_interval)
                        assert got is None or data_interval is not None
                        continue
                    assert _norm_ranges(ks.scan_ranges(g, i, budget, data_interval=data_interval)) \
                        == _norm_ranges(jks.scan_ranges(jg, ji, budget, data_interval=data_interval))
    with pytest.raises(ValueError):
        keyspace_for(sft, "attr:nope")
    with pytest.raises(ValueError):
        keyspace_for(sft, "nope")


def _point_columns(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-150, -60], [150, 60], (8, 2))
    c = centres[rng.integers(0, 8, n)] + rng.normal(0, 2.0, (n, 2))
    return {
        "name": np.array(["a", "b", "c", "d"], object)[rng.integers(0, 4, n)],
        "count": rng.integers(0, 1000, n),
        "val": np.round(rng.uniform(0, 10, n), 2),
        "dtg": T0 + rng.integers(0, 60 * DAY, n),
        "geom": np.clip(c, [-180, -90], [180, 90]).astype(np.float32).astype(np.float64),
    }


def test_index_build_equals_the_reference():
    cols = _point_columns(5000, seed=1)
    cols["dtg"][::7] = cols["dtg"][0]  # ties: the stable order decides
    cols["geom"][::5] = cols["geom"][0]
    sft, jsft = SimpleFeatureType.create("t", POINT_SPEC), JSFT.create("t", POINT_SPEC)
    batch = FeatureBatch.from_columns(sft, cols)
    jbatch = JBatch.from_columns(jsft, cols)
    for name in default_indices(sft) + ["attr:count"]:
        for psize in (64, 1000, 1 << 20):
            got = build.build_index(keyspace_for(sft, name), batch, psize)
            want = jbuild.build_index(jkeyspace(jsft, name), jbatch, psize)
            np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
            for k in want.keys:
                np.testing.assert_array_equal(got.keys[k], want.keys[k])
            assert [vars(p) for p in got.partitions] == [
                {k: v for k, v in vars(p).items() if k in vars(got.partitions[0])}
                for p in want.partitions]


@pytest.mark.parametrize("dtype", ["u64", "i32", "i16span", "f64", "obj"])
def test_parallel_stable_sort_equals_lexsort(dtype, monkeypatch):
    """The host build's row-range sort and its merge equal numpy's stable
    lexsort, ties and all, at more rows than one range holds."""
    monkeypatch.setattr(build, "PARALLEL_MIN_ROWS", 64)
    rng = np.random.default_rng(7)
    n = 5000
    key = {"u64": rng.integers(0, 50, n).astype(np.uint64) << np.uint64(40),
           "i32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32) // 1000,
           "i16span": rng.integers(-5, 9, n).astype(np.int64),
           "f64": np.round(rng.normal(0, 1, n), 1),
           "obj": np.array([f"k{v}" for v in rng.integers(0, 40, n)], object)}[dtype]
    second = rng.integers(0, 3, n).astype(np.int32)
    np.testing.assert_array_equal(build._sort_order([key]), np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(build._sort_order([second, key]), np.lexsort((key, second)))


@pytest.fixture(scope="module")
def stores():
    cols = _point_columns(1 << 13, seed=2)
    tds = MemoryDataStore(partition_size=1 << 10, device="cpu")
    jds = JMemory(partition_size=1 << 10)
    for ds in (tds, jds):
        ds.create_schema("t", POINT_SPEC)
        ds.write("t", cols)
    return tds, jds


def _plan_view(plan):
    return (plan.index_name, [(n, c) for n, c in plan.candidates], _norm_ranges(plan.ranges),
            repr(plan.compiled.device_part), repr(plan.compiled.residual_part),
            plan.compiled.device_cols, plan.agg_bounds is None)


@pytest.mark.parametrize("ecql", ECQL)
def test_plans_equal_the_reference(stores, ecql):
    tds, jds = stores
    got, want = tds.plan("t", ecql), jds.plan("t", ecql)
    assert _plan_view(got) == _plan_view(want)
    assert got.explain() == want.explain()
    # without the write-time stats: the heuristic costs
    from geomesa_tpu.query.plan import plan_query as jplan_query
    from geomesa_tpu_torch.query.plan import plan_query

    ts, js = tds._state("t"), jds._state("t")
    got = plan_query(ts.sft, ts.indices, Query(filter=ecql), data_interval=ts.data_interval)
    want = jplan_query(js.sft, js.indices, JQuery(filter=ecql), data_interval=js.data_interval)
    assert _plan_view(got) == _plan_view(want)


def test_plan_on_an_empty_type_and_the_range_budget(stores):
    tds, jds = MemoryDataStore(device="cpu"), JMemory()
    for ds in (tds, jds):
        ds.create_schema("e", POINT_SPEC)
    q = ECQL[50]
    assert tds.explain("e", q) == jds.explain("e", q)
    tds, jds = stores
    sft_budget = POINT_SPEC + ";geomesa.scan.ranges.target=40"
    t2, j2 = MemoryDataStore(device="cpu"), JMemory()
    for ds in (t2, j2):
        ds.create_schema("b", sft_budget)
        ds.write("b", _point_columns(600, seed=4))
    assert _plan_view(t2.plan("b", q)) == _plan_view(j2.plan("b", q))
    assert len(t2.plan("b", q).ranges) <= 40 + 10  # per-bin budgets over a few bins
    from geomesa_tpu import conf as jconf

    with prop_override("scan.ranges.target", 8), jconf.prop_override("scan.ranges.target", 8):
        assert _plan_view(tds.plan("t", q)) == _plan_view(jds.plan("t", q))


def test_full_table_guard(stores):
    tds, jds = stores
    from geomesa_tpu import conf as jconf

    with prop_override("query.block.full.table", True), \
            jconf.prop_override("query.block.full.table", True):
        for ds in (tds, jds):
            with pytest.raises(ValueError, match="full-table scan"):
                ds.plan("t", "count > 5")
            ds.plan("t", ECQL[50])  # ranges: allowed
        # internal scans are exempt
        from geomesa_tpu.query.plan import internal_query as jinternal
        from geomesa_tpu_torch.query.plan import internal_query

        assert tds.plan("t", internal_query(parse_ecql("count > 5"))).ranges is None
        assert jds.plan("t", jinternal(jparse("count > 5"))).ranges is None
    # the schema's own flag
    t2, j2 = MemoryDataStore(device="cpu"), JMemory()
    for ds in (t2, j2):
        ds.create_schema("g", POINT_SPEC + ";geomesa.block.full.table=true")
        ds.write("g", _point_columns(100, seed=5))
        with pytest.raises(ValueError, match="full-table scan"):
            ds.query("g", "INCLUDE")


def test_max_features_interceptor(stores):
    tds, jds = stores
    from geomesa_tpu import conf as jconf

    with prop_override("query.max.features", 7), jconf.prop_override("query.max.features", 7):
        got, want = tds.query("t", "count > 5"), jds.query("t", "count > 5")
        assert len(got) == len(want) == 7
        np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
        # an explicit cap wins; internal queries are exempt
        assert len(tds.query("t", Query("count > 5", max_features=9))) == 9
        from geomesa_tpu_torch.query.plan import internal_query

        assert len(tds.query("t", internal_query("count > 5"))) == len(
            jds.query("t", JQuery("count > 5", hints={"internal": True})))


class AddCount(interceptor.QueryInterceptor):
    """A declared interceptor (loaded by dotted path): ANDs count >= 500."""

    def rewrite(self, query, sft):
        import dataclasses

        from geomesa_tpu_torch.filter import ast

        return dataclasses.replace(query, filter=ast.And((query.parsed(), ast.Compare(">=", "count", 500))))


class JAddCount(jic.QueryInterceptor):
    def rewrite(self, query, sft):
        import dataclasses

        from geomesa_tpu.filter import ast

        return dataclasses.replace(query, filter=ast.And((query.parsed(), ast.Compare(">=", "count", 500))))


class Veto(interceptor.QueryInterceptor):
    def guard(self, plan):
        if plan.index_name == "z2":
            raise ValueError("z2 vetoed")


def test_declared_interceptor_chain():
    cols = _point_columns(2000, seed=6)
    t2, j2 = MemoryDataStore(partition_size=256, device="cpu"), JMemory(partition_size=256)
    t2.create_schema("i", POINT_SPEC + f";geomesa.query.interceptors={__name__}.AddCount:{__name__}.Veto")
    j2.create_schema("i", POINT_SPEC + f";geomesa.query.interceptors={__name__}.JAddCount")
    for ds in (t2, j2):
        ds.write("i", cols)
    q = "BBOX(geom, -180, -90, 180, 90) AND dtg DURING 2020-01-05T00:00:00Z/2020-01-20T00:00:00Z"
    got, want = t2.query("i", q), j2.query("i", q)
    assert len(got) and (got.batch.column("count") >= 500).all()
    np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
    with pytest.raises(ValueError, match="z2 vetoed"):
        t2.query("i", "BBOX(geom, -10, 35, 30, 60)")
    chain = interceptor.interceptors_for(t2.get_schema("i"))
    assert [type(c).__name__ for c in chain] == ["MaxFeaturesInterceptor", "AddCount", "Veto"]
    with pytest.raises(ValueError, match="bad interceptor path"):
        interceptor._load_dotted("nodots")
