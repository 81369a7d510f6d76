"""Port parity for the GeoTools writer: ``FeatureWriter``,
``DataStoreAdapter.get_feature_writer_append`` and ``dispose`` of
``geomesa_tpu_torch.api`` against ``geomesa_tpu.api``, through
``DataStoreFinder`` over the memory store and the file-system store
(``device="cpu"``).

With explicit fids the two adapters store the same rows (every column, in
the same order, and the same counts under a filter). Generated fids keep
the reference's form, ``<type>.<16 hex>``, unique across writer sessions.
A geometry column may mix WKT strings, ``Point`` objects and ``(x, y)``
pairs. ``close`` writes and flushes once; ``dispose`` closes a store that
has a ``close``.
"""

import re

import numpy as np
import pytest
from _torch_fs_cases import T0, f32

from geomesa_tpu.api import DataStoreFinder as JFinder
from geomesa_tpu.geom import Point as JPoint
from geomesa_tpu_torch.api import DataStoreAdapter, DataStoreFinder, FeatureWriter
from geomesa_tpu_torch.geom import Point

SPEC = "name:String,count:Int,dtg:Date,*geom:Point:srid=4326"
BOX = "BBOX(geom, -20, -10, 30, 25)"
FID = re.compile(r"^t\.[0-9a-f]{16}$")


def _params(kind: str, root) -> "tuple[dict, dict]":
    if kind == "memory":
        return {"memory": "true", "device": "cpu"}, {"memory": "true"}
    return ({"fs.path": str(root / "port"), "device": "cpu"}, {"fs.path": str(root / "jax")})


def _rows(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    xy = f32(rng.uniform([-60, -40], [60, 40], (n, 2)))
    return [{"name": f"n{i % 5}", "count": int(rng.integers(0, 100)),
             "dtg": int(T0 + rng.integers(0, 5 * 86_400_000)), "geom": (float(x), float(y))}
            for i, (x, y) in enumerate(xy)]


def _mixed(r: dict, i: int, point_cls) -> dict:
    """The row with its geometry as WKT, a Point or an (x, y) pair by turns."""
    x, y = r["geom"]
    g = (f"POINT ({x!r} {y!r})", point_cls(x, y), (x, y))[i % 3]
    return dict(r, geom=g)


@pytest.mark.parametrize("kind", ["memory", "fs"])
def test_round_trip_with_explicit_fids_equals_the_reference(kind, tmp_path):
    tp, jp = _params(kind, tmp_path)
    tds, jds = DataStoreFinder.get_data_store(tp), JFinder.get_data_store(jp)
    rows = _rows(300, 5)
    for ds, pt in ((tds, Point), (jds, JPoint)):
        ds.create_schema("t", SPEC)
        with ds.get_feature_writer_append("t") as w:
            for i, r in enumerate(rows[:200]):
                w.write(_mixed(r, i, pt), fid=f"f{i}")
        w = ds.get_feature_writer_append("t")
        for i, r in enumerate(rows[200:], 200):
            w.write(_mixed(r, i, pt), fid=f"f{i}")
        w.close()
        w.close()  # nothing buffered: a no-op
    for q in ("INCLUDE", BOX, f"{BOX} AND count > 40"):
        assert tds.get_feature_source("t").get_count(q) == jds.get_feature_source("t").get_count(q)
    got = tds.query("t", "INCLUDE").batch
    want = jds.query("t", "INCLUDE").batch
    assert [str(f) for f in got.fids] == [str(f) for f in want.fids]
    for k, v in want.columns.items():
        np.testing.assert_array_equal(got.columns[k], v, err_msg=k)
    x = np.array([r["geom"][0] for r in rows])
    y = np.array([r["geom"][1] for r in rows])
    inside = (x >= -20) & (x <= 30) & (y >= -10) & (y <= 25)
    assert tds.get_feature_source("t").get_count(BOX) == int(inside.sum())
    tds.dispose()
    jds.dispose()


def test_close_writes_and_flushes_once(tmp_path):
    class Spy:
        def __init__(self, store):
            self.store, self.calls = store, []

        def get_schema(self, tn):
            return self.store.get_schema(tn)

        def write(self, tn, cols, fids=None):
            self.calls.append(("write", len(fids)))
            return self.store.write(tn, cols, fids=fids)

        def flush(self, tn):
            self.calls.append(("flush", tn))
            return self.store.flush(tn)

    ds = DataStoreFinder.get_data_store({"fs.path": str(tmp_path), "device": "cpu"})
    ds.create_schema("t", SPEC)
    spy = Spy(ds._store)
    w = FeatureWriter(spy, "t")
    for r in _rows(10, 2):
        w.write(r)
    assert spy.calls == [] and ds.get_feature_source("t").get_count() == 0
    w.close()
    assert spy.calls == [("write", 10), ("flush", "t")]
    assert ds.get_feature_source("t").get_count() == 10


def test_generated_fids_are_unique_across_sessions_in_the_reference_form():
    ds = DataStoreFinder.get_data_store({"memory": "true", "device": "cpu"})
    ds.create_schema("t", SPEC)
    rows = _rows(50, 3)
    for _ in range(3):  # three sessions, no fid given
        with ds.get_feature_writer_append("t") as w:
            for r in rows:
                w.write(r)
    fids = [str(f) for f in ds.query("t", "INCLUDE").batch.fids]
    assert len(fids) == len(set(fids)) == 150
    assert all(FID.match(f) for f in fids)
    jds = JFinder.get_data_store({"memory": "true"})
    jds.create_schema("t", SPEC)
    with jds.get_feature_writer_append("t") as w:
        w.write(rows[0])
    assert FID.match(str(jds.query("t", "INCLUDE").batch.fids[0]))


def test_mixed_geometries_land_on_the_same_points():
    ds = DataStoreFinder.get_data_store({"memory": "true", "device": "cpu"})
    ds.create_schema("t", SPEC)
    rows = _rows(30, 4)
    with ds.get_feature_writer_append("t") as w:
        for i, r in enumerate(rows):
            w.write(_mixed(r, i, Point), fid=i)
    got = ds.query("t", "INCLUDE").batch
    order = np.argsort(np.asarray(got.fids, dtype=np.int64))
    np.testing.assert_array_equal(got.columns["geom"][order], np.array([r["geom"] for r in rows]))
    with pytest.raises(TypeError, match="cannot coerce"):
        with ds.get_feature_writer_append("t") as w:
            w.write(dict(rows[0], geom=3.5))


def test_dispose_closes_a_store_that_has_close():
    class Closable:
        closed = 0

        def close(self):
            self.closed += 1

    store = Closable()
    DataStoreAdapter(store).dispose()
    assert store.closed == 1
    ds = DataStoreFinder.get_data_store({"memory": "true", "device": "cpu"})
    ds.dispose()  # a store without close: nothing to do
    ds.create_schema("t", SPEC)  # still usable, as the reference's
