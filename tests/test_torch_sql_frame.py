"""Port parity for ``SpatialFrame`` (``sql/frame.py``) and the store path of
``process/join.py`` ``spatial_join``: ``geomesa_tpu_torch``'s against
``geomesa_tpu``'s over the same rows in a memory store, a file-system
store and the live layer's ``StreamingStore`` over a file-system store.

Each store pair holds a z3 point type ``t`` (labeled rows, null names;
points float32-exact, as the port stages float32 planes) and 70 zone
boxes ``z`` (``tests/test_sql_wide.py``'s right side: it crosses the
engine's 64-window group). The port's stores scan on ``device="cpu"``.
Compared exactly: fids in result order, every column, counts,
``explain``, partitions, ``map_partitions``, ``group_by``,
``value_counts``, ``to_pandas``, and the pair fid sets of every join
shape: the envelope join without an index, a type name on the right, a
``FeatureBatch`` on the right, and the engine path with a resident index.
"""

import numpy as np
import pytest
import torch
from _torch_fs_cases import f32, pair, rows
from _torch_stream_cases import wrap

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.process.join import spatial_join as jspatial_join
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu.sql import SpatialFrame as JFrame
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.process.join import spatial_join
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.sql import SpatialFrame
from geomesa_tpu_torch.store.memory import MemoryDataStore

torch.set_num_threads(2)  # xdist workers share the host's cores

N = 3000
ZONE_SPEC = "zone:String,*geom:Polygon:srid=4326"
KINDS = ("memory", "fs", "stream")
BOX = "BBOX(geom, -100, -45, 120, 55.5)"
DAYS = "dtg DURING 2020-01-02T00:00:00Z/2020-01-05T00:00:00Z"
ZONE_BOX = "BBOX(geom, -60, -30, 60, 40)"


def _zones(m=70, seed=5):
    """m boxes of 2 x 2 to 8 x 8 degrees over the point clusters' span
    (corners on a 1/64-degree grid)."""
    rng = np.random.default_rng(seed)
    c = np.round(rng.uniform([-140, -55], [140, 55], (m, 2)) * 64) / 64
    w = rng.integers(128, 512, (m, 2)) / 64.0
    wkt = [f"POLYGON(({a} {b}, {a + dx} {b}, {a + dx} {b + dy}, {a} {b + dy}, {a} {b}))"
           for (a, b), (dx, dy) in zip(c, w)]
    return {"zone": np.array([f"z{k}" for k in range(m)], object), "geom": np.array(wkt, object)}


def _stores(kind, tmp_path):
    """(port store, JAX store) with ``t`` and ``z`` written; the stream
    pair has flushed rows and 200 more rows in its memtable."""
    cols = rows("z3", N, seed=11, labels=True)
    zones = _zones()
    if kind == "memory":
        tds, jds = MemoryDataStore(partition_size=256, device="cpu"), JMemory(partition_size=256)
        for ds in (tds, jds):
            ds.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
            ds.create_schema("z", ZONE_SPEC)
            ds.write("t", cols)
            ds.write("z", zones, fids=np.arange(70))
        return tds, jds
    tds, jds = pair(str(tmp_path / kind), "z3", psize=256)
    for ds in (tds, jds):
        ds.create_schema("z", ZONE_SPEC)
        ds.write("t", cols)
        ds.write("z", zones, fids=np.arange(70))
        ds.flush("t")
        ds.flush("z")
    if kind == "fs":
        return tds, jds
    tl, jl = wrap(tds, jds)
    fresh = rows("z3", 200, seed=12, labels=True)
    for lay in (tl, jl):
        lay.append("t", fresh, fids=np.arange(90_000, 90_200))
    return tl, jl


@pytest.fixture(scope="module", params=KINDS)
def stores(request, tmp_path_factory):
    tds, jds = _stores(request.param, tmp_path_factory.mktemp(request.param))
    yield request.param, tds, jds
    if request.param == "stream":
        for layer in (tds, jds):
            layer.close(compact=False)


def _same_batch(got, want):
    assert [str(f) for f in got.fids] == [str(f) for f in want.fids]
    assert sorted(got.columns) == sorted(want.columns)
    for k, v in want.columns.items():
        g = got.columns[k]
        if v.dtype == object:
            assert [str(a) for a in g] == [str(a) for a in v], k
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


FRAMES = {
    "include": lambda F, ds: F(ds, "t"),
    "where": lambda F, ds: F(ds, "t").where(BOX),
    "where_where": lambda F, ds: F(ds, "t").where(BOX).filter(DAYS),
    "select_sort_limit": lambda F, ds: F(ds, "t").where(BOX).select("count", "dtg")
    .sort("count", True).limit(100),
    "order_by": lambda F, ds: F(ds, "t").where("count < 200").orderBy("dtg"),
    "auths_none": lambda F, ds: F(ds, "t").where(BOX).with_auths(),
    "auths_a": lambda F, ds: F(ds, "t").where(BOX).with_auths("A"),
    "auths_abc": lambda F, ds: F(ds, "t").with_auths("A", "B", "C").where(DAYS),
    "zones": lambda F, ds: F(ds, "z").where(ZONE_BOX),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frame_equals_the_reference(stores, frame):
    """collect (fids in order, columns), count, len, explain and column."""
    _, tds, jds = stores
    tf, jf = FRAMES[frame](SpatialFrame, tds), FRAMES[frame](JFrame, jds)
    _same_batch(tf.collect(), jf.collect())
    assert tf.count() == jf.count() == len(tf)
    assert tf.explain() == jf.explain()
    name = "count" if frame != "zones" else "zone"
    np.testing.assert_array_equal(tf.column(name), jf.column(name))
    # the frame pushes the whole Query into the store: the store's own answer
    _same_batch(tf.collect(), tds.query(tf.type_name, tf._query()).batch)


def test_frames_are_immutable_and_compose(stores):
    _, tds, _ = stores
    base = SpatialFrame(tds, "t")
    w = base.where(BOX)
    assert base._filter is not w._filter and base.count() > w.count()
    assert w.with_auths("A")._hints == {"auths": ("A",)} and w._hints == {}
    assert w.limit(5).count() == 5


def test_partitions_and_map_partitions_equal_the_reference(stores):
    kind, tds, jds = stores
    tf, jf = SpatialFrame(tds, "t").where(BOX), JFrame(jds, "t").where(BOX)
    tp, jp = list(tf.partitions()), list(jf.partitions())
    assert len(tp) == len(jp) >= (1 if kind == "memory" else 2)
    for a, b in zip(tp, jp):
        _same_batch(a, b)
    for par in (None, 1, 4):
        assert tf.map_partitions(len, parallelism=par) == jf.map_partitions(len, parallelism=par)
    if kind != "stream":  # the live layer's memtable rows are in no partition, in both packages
        assert sum(tf.map_partitions(len, parallelism=4)) == tf.count()
    empty = SpatialFrame(tds, "t").where("count > 5000")
    assert list(empty.partitions()) == [] and empty.map_partitions(len, parallelism=4) == []


@pytest.mark.parametrize("agg", ["count", "sum", "min", "max", "mean", "median"])
def test_group_by_and_value_counts_equal_the_reference(stores, agg):
    _, tds, jds = stores
    tf = SpatialFrame(tds, "t").where(f"{BOX} AND name IS NOT NULL")
    jf = JFrame(jds, "t").where(f"{BOX} AND name IS NOT NULL")
    if agg == "median":
        with pytest.raises(ValueError, match="unknown aggregation"):
            jf.group_by("name", "val", agg)
        with pytest.raises(ValueError, match="unknown aggregation"):
            tf.group_by("name", "val", agg)
        return
    got, want = tf.group_by("name", "val", agg), jf.group_by("name", "val", agg)
    assert got == want and list(got) == list(want)
    assert tf.value_counts("count") == jf.value_counts("count")
    assert tf.value_counts("name") == jf.value_counts("name")


def test_to_pandas_equals_the_reference(stores):
    import pandas as pd

    _, tds, jds = stores
    for fn in (lambda F, ds: F(ds, "t").where(BOX).with_auths("A", "B", "C"),
               lambda F, ds: F(ds, "z").where(ZONE_BOX)):
        pd.testing.assert_frame_equal(fn(SpatialFrame, tds).to_pandas(), fn(JFrame, jds).to_pandas())


def test_to_arrow_raises_naming_the_roadmap(stores):
    _, tds, _ = stores
    with pytest.raises(NotImplementedError, match="ROADMAP §3, 'Arrow responses'"):
        SpatialFrame(tds, "t").to_arrow()


# -- spatial_join --------------------------------------------------------------


def _pair_fids(left, right, pairs) -> list:
    return sorted((str(left.fids[i]), str(right.fids[j])) for i, j in pairs)


JOINS = [("within", None), ("intersects", None), ("contains", None), ("dwithin", 0.75)]


@pytest.mark.parametrize("on,distance", JOINS)
def test_type_name_join_equals_the_reference(stores, on, distance):
    """The store path with a type name on the right (right_filter keeps
    part of the zones), its left side's scan under the pushed-down
    extent."""
    _, tds, jds = stores
    kw = {"on": on, "distance": distance, "left_filter": "count < 700", "right_filter": ZONE_BOX}
    got, want = spatial_join(tds, "t", "z", **kw), jspatial_join(jds, "t", "z", **kw)
    _same_batch(got[0], want[0])
    _same_batch(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert _pair_fids(*got) == _pair_fids(*want)
    if on != "contains":  # a point contains no zone
        assert len(got[2]) > 0


@pytest.mark.parametrize("on,distance", JOINS)
def test_batch_join_equals_the_reference(stores, on, distance):
    """The store path with a FeatureBatch on the right and no index: the
    70 zones collected, through SpatialFrame and a _BatchView."""
    _, tds, jds = stores
    tz, jz = SpatialFrame(tds, "z").collect(), JFrame(jds, "z").collect()
    kw = {"on": on, "distance": distance, "left_filter": DAYS}
    got, want = spatial_join(tds, "t", tz, **kw), jspatial_join(jds, "t", jz, **kw)
    assert got[1] is tz
    _same_batch(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("distance", [None, 0.5])
@pytest.mark.parametrize("left_filter", [None, DAYS])
def test_envelope_join_without_an_index_equals_the_reference(stores, distance, left_filter):
    """The envelope join of the left type's scan against 70 windows:
    rows index the scan's batch, in both packages."""
    _, tds, jds = stores
    envs = SpatialFrame(tds, "z").collect().bboxes("geom")
    got = spatial_join(tds, "t", envs, distance=distance, left_filter=left_filter)
    want = jspatial_join(jds, "t", envs, distance=distance, left_filter=left_filter)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.wins, want.wins)
    assert got.pairs > 0 and got.strategy == want.strategy
    lf = left_filter or "INCLUDE"
    np.testing.assert_array_equal(tds.query("t", Query(filter=lf)).batch.fids,
                                  jds.query("t", JQuery(filter=lf)).batch.fids)


def test_envelope_join_without_an_index_runs_on_the_store_device(stores, monkeypatch):
    """No device_index: the engine runs where the store scans (here the
    CPU, which the store was asked for); nothing picks the CPU by itself."""
    from geomesa_tpu_torch.join import JoinEngine

    _, tds, _ = stores
    seen = []
    real = JoinEngine.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self.device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(JoinEngine, "__init__", spy)
    assert spatial_join(tds, "t", np.array([[-180.0, -90.0, 180.0, 90.0]])).pairs > 0
    assert seen == [torch.device("cpu")] and tds.device == "cpu"


@pytest.fixture(scope="module")
def indexes(stores):
    _, tds, jds = stores
    return DeviceIndex(tds, "t", device="cpu"), JIndex(jds, "t")


@pytest.mark.parametrize("on,distance", JOINS)
def test_engine_join_equals_the_reference_and_the_store_path(stores, indexes, on, distance):
    """With a resident index the join engine answers, its left batch the
    rows the pairs reference; the pair fid sets equal the reference's
    engine path and the store path's."""
    _, tds, jds = stores
    tdi, jdi = indexes
    kw = {"on": on, "distance": distance, "left_filter": DAYS, "right_filter": ZONE_BOX}
    got = spatial_join(tds, "t", "z", device_index=tdi, **kw)
    want = jspatial_join(jds, "t", "z", device_index=jdi, **kw)
    _same_batch(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    store_path = spatial_join(tds, "t", "z", **kw)
    assert _pair_fids(*got) == _pair_fids(*store_path)
    assert len(np.unique(got[2][:, 0])) == len(got[0])


def test_engine_join_takes_the_store_path_only_for_a_schema_it_cannot_serve(stores, indexes,
                                                                            monkeypatch):
    """``prepare``'s ValueError (a schema with no geometry) sends the join
    down the store path, as in the reference; any other error, such as a
    failed launch on the card, propagates."""
    from geomesa_tpu_torch.join import JoinEngine

    _, tds, _ = stores
    tdi, _ = indexes
    kw = {"on": "within", "left_filter": DAYS, "right_filter": ZONE_BOX}
    want = _pair_fids(*spatial_join(tds, "t", "z", **kw))

    def no_geometry(self, conf=None):
        raise ValueError("spatial join needs a geometry field on 't'")

    monkeypatch.setattr(JoinEngine, "prepare", no_geometry)
    assert _pair_fids(*spatial_join(tds, "t", "z", device_index=tdi, **kw)) == want

    def launch_failed(self, conf=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(JoinEngine, "prepare", launch_failed)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        spatial_join(tds, "t", "z", device_index=tdi, **kw)


def test_join_arguments_refused_as_the_reference(stores, indexes):
    _, tds, jds = stores
    tdi, _ = indexes
    for sj, ds in ((spatial_join, tds), (jspatial_join, jds)):
        with pytest.raises(ValueError, match="distance"):
            sj(ds, "t", "z", on="dwithin")
        with pytest.raises(ValueError, match="unknown join predicate"):
            sj(ds, "t", "z", on="touches")
    with pytest.raises(NotImplementedError, match="item 7"):
        spatial_join(tds, "t", "z", device_index=tdi, mesh=object())
    with pytest.raises(NotImplementedError, match="item 7"):
        spatial_join(tds, "t", np.zeros((1, 4)), mesh=object())


def test_a_store_on_the_card_raises_through_the_frame(monkeypatch):
    """The frame catches nothing: a store on the card without CUDA raises
    out of collect, count and the join's pushdown."""
    ds = MemoryDataStore()
    ds.create_schema("t", "count:Int,*geom:Point:srid=4326")
    ds.write("t", {"count": [1, 2], "geom": np.zeros((2, 2))})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frame = SpatialFrame(ds, "t").where("BBOX(geom, -1, -1, 1, 1)")
    for call in (frame.collect, frame.count, lambda: list(frame.partitions())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    right = FeatureBatch.from_columns(SimpleFeatureType.create("r", ZONE_SPEC),
                                      {"zone": ["a"], "geom": ["POLYGON((-1 -1, 1 -1, 1 1, -1 -1))"]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spatial_join(ds, "t", right)


def test_point_right_side_joins_equal_the_reference(tmp_path):
    """A point type on both sides (dwithin and intersects), memory stores."""
    cols = rows("z3", 1500, seed=21)
    pts = {"name": np.array(["s"] * 40, object), "count": np.arange(40),
           "val": np.zeros(40), "dtg": np.full(40, 1_577_900_000_000),
           "geom": f32(cols["geom"][::37][:40] + 0.01)}
    tds, jds = MemoryDataStore(device="cpu"), JMemory()
    for ds in (tds, jds):
        ds.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
        ds.create_schema("s", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
        ds.write("t", cols)
        ds.write("s", pts)
    for on, d in (("dwithin", 0.5), ("intersects", None)):
        got = spatial_join(tds, "t", "s", on=on, distance=d)
        want = jspatial_join(jds, "t", "s", on=on, distance=d)
        _same_batch(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    tb = FeatureBatch.from_columns(SimpleFeatureType.create("s", "*geom:Point:srid=4326"),
                                   {"geom": pts["geom"]})
    jb = JBatch.from_columns(JSFT.create("s", "*geom:Point:srid=4326"), {"geom": pts["geom"]})
    got = spatial_join(tds, "t", tb, on="dwithin", distance=1.0)
    want = jspatial_join(jds, "t", jb, on="dwithin", distance=1.0)
    np.testing.assert_array_equal(got[2], want[2])
