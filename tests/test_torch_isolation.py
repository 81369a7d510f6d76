"""The port stands alone: ``geomesa_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package (also on a non-point xz2 workload,
the store path through ``DataStoreFinder`` and ``MemoryDataStore`` with a
resident index staged from it, the kNN, tube and proximity processes,
``run_stats``, a scheduler run with fused groups, a streaming index, a join
and a BIN request, and the file-system store: writes, flushes under a
partition scheme, queries, the pushdowns, a reopen with verification,
and its streaming live layer: an append, a merged query, a reopen that
replays the WAL and a compaction, with a subscription matched in process
and over HTTP, a ``device_trace`` block around a traced store query, and
the SQL layer: a ``SpatialFrame`` collected and a store-path
``spatial_join``), none of them loads ``pyarrow`` or ``pandas`` either,
and entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # xdist workers share the host's cores

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "geomesa_tpu_torch"

_WORKLOAD = r"""
import sys
import numpy as np
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.process.density import density
from geomesa_tpu_torch.store.direct import BatchStore
from geomesa_tpu_torch import convert, kernels
from geomesa_tpu_torch.kernels import _build

sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
rng = np.random.default_rng(0)
n = 500
cols = {
    "count": rng.integers(0, 10, n),
    "dtg": rng.integers(1_577_836_800_000, 1_580_515_200_000, n),
    "geom": rng.uniform(-50, 50, (n, 2)),
}
batch = FeatureBatch.from_columns(sft, cols)
di = DeviceIndex(BatchStore(batch), "t", z_planes=True, device="cpu")
q = "BBOX(geom, -10, -10, 30, 30) AND dtg DURING 2020-01-03T00:00:00Z/2020-01-09T00:00:00Z"
assert di.count(q, loose=True) >= di.count(q) == len(di.query(q))
inter = DeviceIndex(BatchStore(batch), "t", z_planes=True, dim_planes=False, device="cpu")
assert inter.count(q, loose=True) == di.count(q, loose=True)
count_fn, ops = inter.loose_scan_kernel(q)
assert int(count_fn(*ops)) == inter.count(q, loose=True)
from geomesa_tpu_torch.api import DataStoreFinder
from geomesa_tpu_torch.process.knn import knn
from geomesa_tpu_torch.process.statsproc import run_stats
from geomesa_tpu_torch.query.plan import Query
mds = DataStoreFinder.get_data_store({"memory": "true", "device": "cpu"})
mds.create_schema("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
mds.write("t", cols)
assert mds.get_feature_source("t").get_count(q) == di.count(q)
assert "Chosen index: z3" in mds.explain("t", q)
assert DeviceIndex(mds, "t", z_planes=True, device="cpu").count(q) == di.count(q)
assert len(knn(mds, "t", 0.0, 0.0, 5)[0]) == 5
assert run_stats(mds, "t", Query(q), 'Count();TopK("count")').to_json()[0]["count"] == di.count(q)
assert density(mds, "t", Query(q), Envelope(-50, -50, 50, 50), 8, 8, device="cpu").sum() == di.count(q)
cols[VIS_COLUMN] = rng.choice(["", "A", "A&B"], n)
store = BatchStore(FeatureBatch.from_columns(sft, cols))
ldi = DeviceIndex(store, "t", device="cpu")
env = Envelope(-50, -50, 50, 50)
grid = density(store, "t", q, env, 32, 16, device_index=ldi, auths=("A",))
assert grid.sum() == ldi.count(q, auths=("A",)) < di.count(q)
seq = ldi.stats(q, 'Count();MinMax("count");Histogram("count",10,0,10)', auths=("A",))
assert seq.to_json()[0]["count"] == grid.sum()
psft = SimpleFeatureType.create("p", "name:String,*geom:Polygon:srid=4326")
x0, y0 = rng.uniform(-50, 40, n), rng.uniform(-50, 40, n)
wkt = [f"POLYGON (({a} {b}, {a + 2} {b}, {a + 2} {b + 1}, {a} {b}, {a} {b}))"
       for a, b in zip(x0, y0)]
pbatch = FeatureBatch.from_columns(psft, {"name": ["x"] * n, "geom": wkt})
pdi = DeviceIndex(BatchStore(pbatch), "p", z_planes=True, device="cpu")
assert pdi._z_kind == "xz2"
pq = "BBOX(geom, -10, -10, 30, 30)"
assert pdi.count(pq, loose=True) >= pdi.count(pq) == len(pdi.query(pq)) > 0
rq = "BBOX(geom, -10, -10, 30, 30) AND TOUCHES(geom, POLYGON((0 0, 10 0, 10 10, 0 10, 0 0)))"
assert pdi.count(rq) <= pdi.count(pq)
assert pdi.stats(pq, "Count()", loose=True).to_json()[0]["count"] == pdi.count(pq, loose=True)
assert pdi.density(pq, env, 8, 8) is None
from geomesa_tpu_torch.process.knn import knn
from geomesa_tpu_torch.process.proximity import proximity_search
from geomesa_tpu_torch.process.tube import tube_select
nb, nd = knn(store, "t", 0.0, 0.0, 7, base_filter="count > 2", device_index=ldi, auths=("A",))
assert len(nb) == 7 and (nb.column("count") > 2).all() and (np.diff(nd) >= 0).all()
wb, _ = knn(store, "t", 0.0, 0.0, 5, base_filter="count > 2 OR dtg IS NULL", device_index=di)
assert len(wb) == 5  # a host residual: the expanding windows answer
track = np.array([[-20.0, -20.0], [0.0, 5.0], [20.0, 20.0]])
tt = np.array([1_577_836_800_000, 1_578_900_000_000, 1_580_000_000_000])
tb = tube_select(store, "t", track, tt, 5.0, 86_400_000 * 5, device_index=ldi, auths=("A",))
assert 0 < len(tb) <= len(ldi.window_union_query([[-25, -25, 25, 25]], auths=("A",)))
pb, pd = proximity_search(store, "t", [(0.0, 0.0), (30.0, -30.0)], 8.0, base_filter="count < 8",
                          device_index=ldi, auths=("A",))
assert len(pb) > 0 and (pd <= 8.0).all()
from geomesa_tpu_torch.sched import FusableQuery, QueryScheduler, SchedConfig
sched = QueryScheduler(SchedConfig(max_inflight=2, fusion_window_ms=5.0, default_deadline_ms=None))
tiles = [f"BBOX(geom, {x}, {y}, {x + 20}, {y + 20}) AND dtg DURING "
         "2020-01-03T00:00:00Z/2020-01-09T00:00:00Z" for x, y in ((-40, -40), (-10, 0), (10, 10))]
reqs = [sched.submit(fuse=FusableQuery(ix, t, op, loose=True))
        for ix in (di, inter) for t in tiles for op in ("count", "query")]
got = [sched.wait(r) for r in reqs]
sched.close(timeout=5.0)
want = [f(t) for ix in (di, inter) for t in tiles
        for f in (lambda t, ix=ix: ix.count(t, loose=True), lambda t, ix=ix: ix.query(t, loose=True))]
assert [g if isinstance(g, int) else sorted(g.fids) for g in got] == \
    [w if isinstance(w, int) else sorted(w.fids) for w in want]
from geomesa_tpu_torch.device_cache import StreamingDeviceIndex
from geomesa_tpu_torch.stream.log import Put, Remove


class Feed:
    def __init__(self):
        self.fns = []

    def add_listener(self, fn):
        self.fns.append(fn)


sdi = StreamingDeviceIndex(BatchStore(batch), "t", z_planes=True, capacity=1024, device="cpu")
feed = Feed()
sdi.attach_live(feed)
for fn in feed.fns:
    fn(Put({k: v[:50] for k, v in cols.items() if k != VIS_COLUMN}, np.arange(n, n + 50)))
    fn(Remove(np.arange(0, 20)))
assert len(sdi) == n + 30 and sdi.restages == 1 and sdi.delta_appends == 1
assert sdi.count(q, loose=True) >= sdi.count(q) == len(sdi.query(q))
assert sdi.fused_loose_counts([q], loose=True) == [sdi.count(q, loose=True)]
from geomesa_tpu_torch.join import JoinEngine
from geomesa_tpu_torch.process.join import spatial_join
from geomesa_tpu_torch.results.binrider import resident_bin
wins = np.array([[-20.0, -20.0, 0.0, 0.0], [-5.0, -5.0, 25.0, 25.0]])
res = JoinEngine(sdi).join(wins)
assert res.engine == "host" and res.pairs == sum(len(sdi.window_union_query([w])) for w in wins)
rows, rwins = sdi.window_pairs_query(wins)
assert len(rows) == res.pairs
rb = FeatureBatch.from_columns(psft, {"name": ["r"], "geom": ["POLYGON((-5 -5, 25 -5, 25 25, -5 25, -5 -5))"]})
lb, _, pairs = spatial_join(store, "t", rb, on="within", device_index=di)
assert len(pairs) == len(lb) > 0
bq = "BBOX(geom, -10, -10, 30, 30)"
assert resident_bin(di, bq, "count", sort=True) == di.bin_rider(bq, "count", sort=True)
assert len(sdi.bin_rider(bq, "count")) == 16 * sdi.count(bq)
import tempfile
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.process.statsproc import run_stats as fs_stats
root = tempfile.mkdtemp()
fds = DataStoreFinder.get_data_store({"fs.path": root, "device": "cpu"})
fds.create_schema("t", "count:Int,dtg:Date,*geom:Point:srid=4326;geomesa.fs.partition-scheme=daily:z2-2bit")
with prop_override("store.chunk.rows", 16):
    fds.write("t", {k: v for k, v in cols.items() if k != VIS_COLUMN})
    assert fds.get_feature_source("t").get_count(q) == di.count(q) == fds.count("t", q)
assert fds.verify_chunk_stats("t") == [] and fds.verify_partitions("t") == []
assert density(fds, "t", Query(q), Envelope(-50, -50, 50, 50), 8, 8, device="cpu").sum() > 0
assert fs_stats(fds, "t", Query(q), 'Count();MinMax("count")').to_json()[0]["count"] == di.count(q)
with prop_override("store.verify", "always"):
    from geomesa_tpu_torch.store.fs import FileSystemDataStore
    again = FileSystemDataStore(root, device="cpu")
    assert len(again.query("t", q)) == di.count(q)
from geomesa_tpu_torch.store.stream import StreamingStore
layer = StreamingStore(again)
layer.append("t", {k: v[:40] for k, v in cols.items() if k != VIS_COLUMN}, fids=np.arange(n, n + 40))
live = layer.query("t", q)
x, y, t = cols["geom"][:40, 0], cols["geom"][:40, 1], cols["dtg"][:40]
fresh = (x >= -10) & (x <= 30) & (y >= -10) & (y <= 30) & (t >= 1_578_009_600_000) & (t <= 1_578_528_000_000)
assert len(live) == layer.count("t", q) == di.count(q) + int(fresh.sum())
layer.close(compact=False)
relayer = StreamingStore(FileSystemDataStore(root, device="cpu"))
assert relayer.count("t", q) == len(live)
relayer.compact_now("t")
assert not relayer._runs_snapshot("t") and relayer.count("t", q) == len(live)
from geomesa_tpu_torch.pubsub import PubSubHub
hub = PubSubHub(relayer)
sub = hub.subscribe("t", {"bbox": [-10, -10, 30, 30], "cql": "count > 2"}, tenant="a", auths=None)
relayer.append("t", {k: v[40:80] for k, v in cols.items() if k != VIS_COLUMN}, fids=np.arange(n + 40, n + 80))
gen = hub.events("t", sub["id"], sub["cursor"], 0.05)
ev = next(e for e in gen if e[0] == "match")
gen.close()
x2, y2, c2 = cols["geom"][40:80, 0], cols["geom"][40:80, 1], cols["count"][40:80]
want = (x2 >= -10) & (x2 <= 30) & (y2 >= -10) & (y2 <= 30) & (c2 > 2)
# one fused join for the acked append, one for the cursor's replay of it
assert sorted(ev[2].fids) == sorted(n + 40 + np.nonzero(want)[0]) and hub.matcher.launches == 2
hub.close()
from geomesa_tpu_torch import profiling
from geomesa_tpu_torch.tracing import TRACER
t2 = cols["dtg"][40:80]
fresh2 = (x2 >= -10) & (x2 <= 30) & (y2 >= -10) & (y2 <= 30) & (t2 >= 1_578_009_600_000) & (t2 <= 1_578_528_000_000)
relayer.compact_now("t")  # the count scans partitions: store runs, so launches to trace
with prop_override("trace.device.dir", root + "/_traces"), TRACER.trace("iso") as tr:
    assert tr.sampled and relayer.count("t", q) == len(live) + int(fresh2.sum())
import os
assert [f for f in os.listdir(root + "/_traces") if f.startswith(tr.trace_id)]
assert profiling.timings()["query.scan"]["count"] > 0
relayer.close()
from geomesa_tpu_torch import sql
from geomesa_tpu_torch.sql import SpatialFrame
frame = SpatialFrame(mds, "t").where(q).select("count", "dtg").sort("count", True)
assert list(frame.collect().fids) == list(mds.query("t", frame._query()).batch.fids)
assert frame.count() == di.count(q) and frame.explain() == mds.explain("t", frame._query())
mds.create_schema("zones", "name:String,*geom:Polygon:srid=4326")
mds.write("zones", {"name": ["z"], "geom": ["POLYGON((-10 -10, 30 -10, 30 30, -10 30, -10 -10))"]})
left, right, jpairs = spatial_join(mds, "t", "zones", on="within", left_filter=q)
assert len(jpairs) == di.count(q + " AND WITHIN(geom, POLYGON((-10 -10, 30 -10, 30 30, -10 30, -10 -10)))")
cell = sql.st_geomFromGeoHash(sql.st_geoHash(sql.st_point(1.0, 2.0))).envelope
assert cell.xmin <= 1.0 <= cell.xmax and cell.ymin <= 2.0 <= cell.ymax
assert not _build._libs  # CPU tensors never build or load a kernel
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu.")
             or m == "pyarrow" or m.startswith("pyarrow.")
             or m == "pandas" or m.startswith("pandas."))
print("LOADED", bad)
"""


def test_port_workload_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMESA_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"  # the child's torch pool, as the cap above
    out = subprocess.run(
        [sys.executable, "-c", _WORKLOAD], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


_SERVER_WORKLOAD = r"""
import json, sys, tempfile, urllib.error, urllib.request
import numpy as np
from geomesa_tpu_torch.kernels import _build
from geomesa_tpu_torch.server import serve_background
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.memory import MemoryDataStore

rng = np.random.default_rng(3)
n = 600
cols = {"name": rng.choice(["a", "b"], n), "count": rng.integers(0, 100, n),
        "dtg": 1_577_836_800_000 + rng.integers(0, 5 * 86_400_000, n),
        "geom": np.stack([rng.uniform(-50, 50, n), rng.uniform(-40, 40, n)], 1).astype(np.float32)}
spec = "name:String,count:Int,dtg:Date,*geom:Point:srid=4326"
fds = FileSystemDataStore(tempfile.mkdtemp(), partition_size=128, device="cpu")
mds = MemoryDataStore(device="cpu")
for ds in (fds, mds):
    ds.create_schema("t", spec)
    ds.write("t", cols)
fds.flush("t")
q = urllib.request.quote
box = q("BBOX(geom, -10, -10, 30, 30)")


def call(base, path, method="GET", body=None):
    req = urllib.request.Request(base + path, method=method,
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


paths = ["/capabilities", f"/count/t?cql={box}", f"/count/t?cql={box}&loose=1",
         f"/features/t?cql={box}&maxFeatures=5", f"/features/t?cql={box}&f=bin&track=name",
         f"/features/t?f=arrow", f"/explain/t?cql={box}",
         "/density/t?bbox=-50,-40,50,40&width=8&height=4", "/stats/t?stats=Count()",
         "/knn/t?x=0&y=0&k=3", "/tube/t?track=0,0,1577836800000;5,5,1577900000000",
         "/proximity/t?points=0,0&distance=5", "/refresh/t", "/metrics", "/healthz", "/readyz",
         "/stats", "/stats/sched", "/stats/store", "/stats/mesh", "/stats/slo", "/stats/ledger",
         "/stats/stream", "/stats/replica", "/stats/pubsub", "/debug/traces",
         "/subscribe/t?id=1", "/wal/t", "/snapshot/t"]
codes = {}
for ds, kw in ((mds, {"resident": True, "sched": True}), (fds, {"resident": True, "stream": True})):
    server, _ = serve_background(ds, **kw)
    base = "http://%s:%d" % server.server_address[:2]
    for p in paths:
        codes[p] = call(base, p)[0]
    if kw.get("stream"):
        st, sub = call(base, "/subscribe/t", "POST", {"bbox": [0, 0, 2, 2]})
        sub = json.loads(sub)
        resp = urllib.request.urlopen(f"{base}/subscribe/t?id={sub['id']}", timeout=30)
        body = {"columns": {"name": ["a"], "count": [1], "dtg": [1_577_836_800_000],
                            "geom": [[1.0, 1.0]]}, "fids": ["new"]}
        assert call(base, "/append/t", "POST", body)[0] == 200
        buf = b""
        while b"event: match" not in buf:
            buf += resp.read1(4096)
        resp.close()
        assert b'"id":"new"' in buf and call(base, f"/subscribe/t?id={sub['id']}", "DELETE")[0] == 200
        assert call(base, "/wal/_pubsub")[0] == 200
    assert call(base, "/admin/shutdown", "POST", {})[0] == 200
    server.server_close()
assert [p for p, c in codes.items() if c >= 500 and c != 501] == [], codes
assert codes["/features/t?f=arrow"] == 406 and codes["/wal/t"] == 501
assert not _build._libs  # CPU tensors never build or load a kernel
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu.")
             or m == "pyarrow" or m.startswith("pyarrow."))
print("LOADED", bad)
"""


def test_server_workload_loads_no_jax():
    """A ``serve_background`` session of every endpoint (memory and
    file-system stores, resident, scheduled and live) in a child process
    loads neither ``jax`` nor the JAX package."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMESA_TPU_")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, "-c", _SERVER_WORKLOAD], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+geomesa_tpu\b(?!_torch)|from\s+geomesa_tpu(\.|\s)(?!_torch))"
    r"|geomesa_tpu\.(?!_torch)",
    re.M,
)


SOURCES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def test_the_scan_covers_the_store_modules():
    for rel in ("api.py", "audit.py", "curves/zranges.py", "filter/extract.py", "index/api.py",
                "index/build.py", "index/keyspaces.py", "query/plan.py", "query/interceptor.py",
                "query/runner.py", "store/memory.py", "store/ageoff.py", "stats/sketches.py",
                "process/statsproc.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


def test_the_scan_covers_the_fs_store_modules():
    for rel in ("locking.py", "store/fs.py", "store/partfile.py", "store/partitions.py",
                "store/chunkstats.py", "store/prefetch.py", "store/pushdown.py",
                "store/snapshot.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


def test_the_scan_covers_the_server_modules():
    for rel in ("server.py", "slo.py", "jobs.py", "export.py", "geom/geojson.py",
                "results/negotiate.py", "results/columnar.py", "results/stream.py",
                "tools/cli.py", "tools/__main__.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


def test_the_scan_covers_the_live_layer_modules():
    for rel in ("store/wal.py", "store/stream.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


def test_the_scan_covers_the_sql_modules():
    for rel in ("sql/__init__.py", "sql/functions.py", "sql/frame.py", "geom/clip.py",
                "geom/geohash.py", "geom/wkb.py", "process/join.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


def test_the_scan_covers_the_push_tier_and_profiling_modules():
    for rel in ("pubsub/__init__.py", "pubsub/registry.py", "pubsub/matcher.py",
                "pubsub/delivery.py", "profiling.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


_PYARROW = re.compile(r"^\s*(import\s+pyarrow\b|from\s+pyarrow\b)|\bpyarrow\.", re.M)


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_pyarrow(path):
    """The card's host has no ``pyarrow``: no port module (nor the chip
    script) imports it."""
    hits = [m.group(0) for m in _PYARROW.finditer((ROOT / path).read_text())]
    assert not hits, f"{path}: {hits}"


def test_the_scan_covers_the_scheduler_modules():
    for rel in ("conf.py", "spawn.py", "failpoints.py", "metrics.py", "tracing.py",
                "resilience.py", "ledger.py", "sched/__init__.py", "sched/fusion.py",
                "sched/scheduler.py"):
        assert f"geomesa_tpu_torch/{rel}" in SOURCES, rel


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_jax_imports():
    for bad in ("import jax", "from jax import numpy", "import geomesa_tpu",
                "from geomesa_tpu.ops import zscan", "x = geomesa_tpu.ops"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import geomesa_tpu_torch", "from geomesa_tpu_torch.ops import zscan"):
        assert not _FORBIDDEN.search(ok), ok


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from geomesa_tpu_torch.device import resolve_device
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.store.direct import BatchStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    sft = SimpleFeatureType.create("t", "*geom:Point:srid=4326")
    store = BatchStore(FeatureBatch.from_columns(sft, {"geom": np.zeros((4, 2))}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex(store, "t")
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.process.density import density

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        density(store, "t", "INCLUDE", Envelope(-1, -1, 1, 1), 4, 4)  # the store path
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    mds = MemoryDataStore()
    mds.create_schema("t", "*geom:Point:srid=4326")
    mds.write("t", {"geom": np.zeros((4, 2))})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mds.query("t", "BBOX(geom, -1, -1, 1, 1)")
    assert density(store, "t", "INCLUDE", Envelope(-1, -1, 1, 1), 4, 4, device="cpu").sum() == 4


def test_the_fs_store_refuses_the_cpu_unless_asked(monkeypatch, tmp_path):
    from geomesa_tpu_torch.api import DataStoreFinder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fds = DataStoreFinder.get_data_store({"fs.path": str(tmp_path)})
    fds.create_schema("t", "count:Int,*geom:Point:srid=4326")
    fds.write("t", {"count": [1, 2, 3, 4], "geom": np.zeros((4, 2))})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fds.query("t", "BBOX(geom, -1, -1, 1, 1)")
    cpu = DataStoreFinder.get_data_store({"fs.path": str(tmp_path), "device": "cpu"})
    assert cpu.get_feature_source("t").get_count("BBOX(geom, -1, -1, 1, 1)") == 4


def test_kernel_build_needs_nvcc(monkeypatch):
    from geomesa_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
