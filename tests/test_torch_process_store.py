"""Port parity for the store path of the processes: ``geomesa_tpu_torch``'s
``process/knn.py``, ``tube.py``, ``proximity.py``, ``density.py`` (with a
``Query``) and ``statsproc.py`` ``run_stats`` over a ``MemoryDataStore``
against ``geomesa_tpu``'s over its own, and the port's store path against
the port's resident path (a ``DeviceIndex`` on the same rows).

Rows are AIS-shaped points from a numpy seed with float32-exact
coordinates, labeled for the auth cases; the port scans on
``device="cpu"``. Tolerances: fids and their order equal between the
packages' store paths; fid sets equal between the port's store and
resident paths (their orders follow different indexes); kNN and proximity
distances equal (float64 from the same host coordinates); counted density
grids and stat JSON equal.
"""

import numpy as np
import pytest

from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.process.density import density as jdensity
from geomesa_tpu.process.knn import knn as jknn
from geomesa_tpu.process.proximity import proximity_search as jproximity
from geomesa_tpu.process.statsproc import run_stats as jrun_stats
from geomesa_tpu.process.tube import tube_select as jtube
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope, LineString, Point
from geomesa_tpu_torch.process.density import density
from geomesa_tpu_torch.process.knn import knn
from geomesa_tpu_torch.process.proximity import proximity_search
from geomesa_tpu_torch.process.statsproc import run_stats
from geomesa_tpu_torch.process.tube import tube_select
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.store.direct import BatchStore
from geomesa_tpu_torch.store.memory import MemoryDataStore

T0 = 1_577_836_800_000
DAY = 86_400_000
SPEC = "c:Int,sog:Int,name:String,dtg:Date,*geom:Point:srid=4326"
AUTHS = [None, ("A",), ("A", "B", "C")]
SEVEN = ('Count();MinMax("c");MinMax("dtg");Histogram("sog",16,0,32);'
         'Cardinality("name");TopK("name",3);Frequency("c");Z3Histogram("geom","dtg")')


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-12, 38], [12, 58], (n, 2))
    return {
        "c": np.arange(n),
        "sog": rng.integers(0, 30, n),
        "name": np.array(["cargo", "tanker", "fishing", "tug"], object)[rng.integers(0, 4, n)],
        "dtg": T0 + rng.integers(0, 4 * DAY, n),
        "geom": xy.astype(np.float32).astype(np.float64),
        VIS_COLUMN: np.array(["", "", "A", "B&C", "A|B"], object)[rng.integers(0, 5, n)],
    }


@pytest.fixture(scope="module")
def world():
    cols = _rows(12_000, seed=3)
    tds = MemoryDataStore(partition_size=1 << 10, device="cpu")
    jds = JMemory(partition_size=1 << 10)
    for ds in (tds, jds):
        ds.create_schema("ais", SPEC)
        ds.write("ais", cols)
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("ais", SPEC), cols)
    bstore = BatchStore(batch)
    di = DeviceIndex(bstore, "ais", z_planes=True, device="cpu")
    return tds, jds, bstore, di


def _track(m, seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([np.linspace(-8, 8, m), np.linspace(42, 54, m)], axis=1) + rng.normal(0, 0.2, (m, 2))
    t = T0 + np.linspace(0, 3 * DAY, m).astype(np.int64)
    return xy, t


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("k,base", [(1, None), (25, None), (200, "sog > 10"), (7, "name = 'tug'")])
def test_knn_store_path(world, k, base, auths):
    tds, jds, bstore, di = world
    for px, py in ((0.0, 48.0), (11.9, 57.9), (-30.0, 10.0)):
        got, gd = knn(tds, "ais", px, py, k, base_filter=base, auths=auths)
        want, wd = jknn(jds, "ais", px, py, k, base_filter=base, auths=auths)
        np.testing.assert_array_equal(got.fids, want.fids)
        np.testing.assert_array_equal(gd, wd)
        res, _ = knn(bstore, "ais", px, py, k, base_filter=base, device_index=di, auths=auths)
        assert sorted(res.fids) == sorted(got.fids)


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("m,buf,dt,base", [(2, 0.3, 3_600_000, None), (9, 1.0, 6 * 3_600_000, None),
                                           (17, 0.6, 12 * 3_600_000, "sog < 20"),
                                           (1, 1.0, 3_600_000, None)])
def test_tube_select_store_path(world, m, buf, dt, base, auths):
    tds, jds, bstore, di = world
    xy, t = _track(m, seed=m)
    got = tube_select(tds, "ais", xy, t, buf, dt, base_filter=base, auths=auths)
    want = jtube(jds, "ais", xy, t, buf, dt, base_filter=base, auths=auths)
    np.testing.assert_array_equal(got.fids, want.fids)
    if m == 1:  # no segment: an empty answer, and no resident window to ask
        assert len(got) == 0
        return
    res = tube_select(bstore, "ais", xy, t, buf, dt, base_filter=base, device_index=di, auths=auths)
    assert sorted(res.fids) == sorted(got.fids)


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("case", ["points", "line", "base"])
def test_proximity_search_store_path(world, case, auths):
    tds, jds, bstore, di = world
    from geomesa_tpu.geom import LineString as JLine
    from geomesa_tpu.geom import Point as JPoint

    if case == "line":
        inputs, jinputs = [LineString([(-5, 45), (5, 50), (8, 44)])], [JLine([(-5, 45), (5, 50), (8, 44)])]
    else:
        pts = [(-5.0, 45.0), (3.5, 51.0), (10.0, 40.0)]
        inputs, jinputs = [Point(*p) for p in pts], [JPoint(*p) for p in pts]
    base = "sog >= 12" if case == "base" else None
    got, gd = proximity_search(tds, "ais", inputs, 0.75, base_filter=base, auths=auths)
    want, wd = jproximity(jds, "ais", jinputs, 0.75, base_filter=base, auths=auths)
    np.testing.assert_array_equal(got.fids, want.fids)
    np.testing.assert_array_equal(gd, wd)
    res, rd = proximity_search(bstore, "ais", inputs, 0.75, base_filter=base, device_index=di,
                               auths=auths)
    order = np.argsort(res.fids)
    assert list(res.fids[order]) == sorted(got.fids)
    np.testing.assert_array_equal(rd[order], gd[np.argsort(got.fids)])


DQ = "BBOX(geom, -6, 40, 9, 55) AND dtg DURING 2020-01-01T12:00:00Z/2020-01-03T12:00:00Z"


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("weight", [None, "sog"])
def test_density_with_a_query_store_path(world, weight, auths):
    tds, jds, bstore, di = world
    env = (-12.0, 38.0, 12.0, 58.0)
    q = Query(filter=DQ, hints={"auths": auths})
    jq = JQuery(filter=DQ, hints={"auths": auths})
    got = density(tds, "ais", q, Envelope(*env), 96, 64, weight_attr=weight, use_device=False)
    want = jdensity(jds, "ais", jq, JEnvelope(*env), 96, 64, weight_attr=weight, use_device=False)
    np.testing.assert_array_equal(got, want)
    # the density kernel's plain version over the store's rows: the same counts
    dev = density(tds, "ais", q, Envelope(*env), 96, 64, weight_attr=weight, device="cpu")
    np.testing.assert_allclose(dev, got, rtol=2e-6, atol=0 if weight is None else 1e-3)
    # the resident path over the same rows: the same grid
    res = density(bstore, "ais", q, Envelope(*env), 96, 64, weight_attr=weight, device_index=di)
    np.testing.assert_allclose(res, got, rtol=2e-6, atol=0 if weight is None else 1e-3)
    # the Query's own auths hint wins over the keyword
    assert np.array_equal(
        density(tds, "ais", q, Envelope(*env), 96, 64, use_device=False, auths=("A", "B", "C")),
        density(tds, "ais", q, Envelope(*env), 96, 64, use_device=False))


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("query", ["INCLUDE", DQ, "sog > 25 AND name = 'tug'"])
def test_run_stats_store_path(world, query, auths):
    tds, jds, bstore, di = world
    got = run_stats(tds, "ais", Query(filter=query, hints={"auths": auths}), SEVEN)
    want = jrun_stats(jds, "ais", JQuery(filter=query, hints={"auths": auths}), SEVEN)
    assert got.to_json() == want.to_json()
    # the resident path: device reductions and host sketches, the same JSON
    res = run_stats(bstore, "ais", query, SEVEN, device_index=di, auths=auths)
    assert res.to_json() == got.to_json()
    # a bare string on the store path carries no auths there, in both packages
    assert run_stats(tds, "ais", query, "Count()", auths=auths).to_json() == \
        jrun_stats(jds, "ais", query, "Count()", auths=auths).to_json()
