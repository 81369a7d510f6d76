"""The file-system store's durability, integrity and I/O contract in the
port (``geomesa_tpu_torch/store/fs.py``), where the JAX package's store
is the reference for what a reader sees.

- Checksums: under ``store.verify`` ``open`` and ``always`` a flipped
  byte quarantines only its partition; queries pruned away from it answer
  as the JAX package's store answers them; a query that touches it raises
  ``PartitionUnavailableError`` in both packages; ``verify_partitions``
  and ``recover`` report it.
- Prefetch: ``io.workers`` 0 and 4 answer the same and leave no worker
  thread behind; ``fail.read.io`` is retried within ``io.retries`` and
  raises typed past it; ``query.timeout`` ends a slow scan.
- Two store objects on one root see each other's flushes.
- The port's own kill matrix: a spawned child runs port code only and is
  SIGKILLed at each ``fail.flush.*`` failpoint, v1 and v2; the reopened
  store serves exactly the old rows (before the publish) or the new
  (after it), its sweep reclaims the leftovers, and a v2 survivor's chunk
  statistics match its rows.
- A failed writer thread fails the flush before anything publishes.
- What the port refuses: ``mesh``, the ``parquet``/``orc`` encodings and a
  root whose manifest names them; ``audit=True`` logs what the JAX
  package's store logs.
- A snapshot pin keeps its generation's files through collection, in
  both packages, until it ages past ``snapshot.pin.ttl.s``.
- No query hint switches visibility off, in the fs and the memory store.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from _torch_fs_cases import props, rows, same, written

from geomesa_tpu import failpoints as jfp
from geomesa_tpu import resilience as jres
from geomesa_tpu_torch import failpoints, metrics, resilience
from geomesa_tpu_torch.store.fs import FileSystemDataStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX = ("BBOX(geom, -40.5, -20.25, 60.75, 45.5) AND "
       "dtg DURING 2020-01-02T00:00:00Z/2020-01-04T12:00:00Z")


def _flip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))


@pytest.mark.parametrize("mode", ["open", "always"])
def test_a_flipped_byte_quarantines_only_its_partition(tmp_path, mode):
    from geomesa_tpu.store.fs import FileSystemDataStore as JFS

    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", None, seed=11, labels=False)
    plan = tds.plan("t", BOX)
    touched = {p.pid for p in tds._pruned_parts("t", plan)}
    victim = next(p for p in tds._types["t"].partitions if p.pid not in touched)
    for ds in (tds, jds):
        _flip(ds._part_path("t", next(p for p in ds._types["t"].partitions if p.pid == victim.pid)))
    with props(store_verify=mode):
        t2 = FileSystemDataStore(tds.root, partition_size=64, device="cpu")
        j2 = JFS(jds.root, partition_size=64)
        if mode == "open":  # the open-time pass found it already
            assert set(t2.store_stats()["types"]["t"]["quarantined"]) == {victim.pid}
            assert set(j2.store_stats()["types"]["t"]["quarantined"]) == {victim.pid}
        same(t2.query("t", BOX), j2.query("t", BOX))
        with pytest.raises(resilience.PartitionUnavailableError, match=f"partition {victim.pid}"):
            t2.query("t", "INCLUDE")
        with pytest.raises(jres.PartitionUnavailableError):
            j2.query("t", "INCLUDE")
        assert set(t2.store_stats()["types"]["t"]["quarantined"]) == {victim.pid}
        assert [e[0] for e in t2.verify_partitions("t")] == [e[0] for e in j2.verify_partitions("t")] \
            == [victim.pid]
        rep, jrep = t2.recover("t"), j2.recover("t")
        assert (rep["files"], rep["gen_repaired"]) == (jrep["files"], jrep["gen_repaired"]) == (0, False)
        same(t2.query("t", BOX), j2.query("t", BOX))  # pruned away: still serving


def test_prefetch_workers_answer_the_same(tmp_path):
    with props(store_chunk_rows=16):
        tds, _ = written(tmp_path, "z3", "daily", seed=12, labels=False)
    results = []
    for workers in (0, 4):
        ds = FileSystemDataStore(tds.root, partition_size=64, io=workers, device="cpu")
        results.append([ds.query("t", f) for f in ("INCLUDE", BOX, "count > 300")])
        assert ds.count("t", BOX) == len(results[-1][1])
    for a, b in zip(*results):
        same(a, b)
    assert not [t for t in threading.enumerate() if t.name.startswith(("geomesa-io", "fs-flush"))]


def test_transient_reads_retry_then_raise_typed(tmp_path):
    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", None, seed=13, labels=False)
    want = jds.query("t", BOX)
    with props(io_retries=2, io_backoff_ms=0.0):
        ds = FileSystemDataStore(tds.root, partition_size=64, device="cpu")
        before = metrics.store_read_retries.value()
        with failpoints.failpoint_override("fail.read.io", "raise:2"):
            same(ds.query("t", BOX), want)
        assert metrics.store_read_retries.value() - before == 2
        ds = FileSystemDataStore(tds.root, partition_size=64, device="cpu")
        with failpoints.failpoint_override("fail.read.io", "raise"):
            with pytest.raises(resilience.PartitionUnavailableError, match="fail.read.io"):
                ds.query("t", BOX)
        with jfp.failpoint_override("fail.read.io", "raise"):
            with pytest.raises(jres.PartitionUnavailableError):
                type(jds)(jds.root, partition_size=64).query("t", BOX)
    from geomesa_tpu_torch.conf import QueryTimeout

    ds = FileSystemDataStore(tds.root, partition_size=64, io=0, device="cpu")
    with props(query_timeout=1), failpoints.failpoint_override("fail.read.io", "sleep:20"):
        with pytest.raises(QueryTimeout):
            ds.query("t", "INCLUDE")


def test_two_store_objects_on_one_root_see_each_others_flushes(tmp_path):
    root = str(tmp_path / "shared")
    a = FileSystemDataStore(root, partition_size=64, device="cpu")
    a.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
    b = FileSystemDataStore(root, partition_size=64, device="cpu")
    a.write("t", rows("z3", 200, seed=1))
    a.flush("t")
    assert len(b.query("t", "INCLUDE")) == 200
    b.write("t", rows("z3", 100, seed=2), fids=np.arange(1000, 1100))
    b.flush("t")
    got = a.query("t", "INCLUDE")
    assert len(got) == 300 and set(got.batch.fids.tolist()) >= set(range(1000, 1100))
    assert a.count("t", "count >= 0") == 300
    assert b.delete("t", list(range(1000, 1050))) == 50
    assert len(a.query("t", "INCLUDE")) == 250
    a.compact("t")
    assert len(b.query("t", "INCLUDE")) == 250


_CHILD = r"""
import numpy as np, sys
from geomesa_tpu_torch.store.fs import FileSystemDataStore
ds = FileSystemDataStore(sys.argv[1], partition_size=128, device="cpu")
rng = np.random.default_rng(2)
n = 300
ds.write("t", {"val": rng.integers(0, 100, n), "dtg": rng.integers(0, 10**9, n),
               "geom": rng.uniform([-180, -90], [180, 90], (n, 2))}, fids=np.arange(10_000, 10_000 + n))
ds.flush("t")
print("flushed without dying")
"""


@pytest.mark.parametrize("fmt", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("failpoint,expect_new", [
    ("fail.flush.after_write", False),
    ("fail.flush.before_publish", False),
    ("fail.flush.after_publish", True),
])
def test_port_kill_matrix(tmp_path, failpoint, expect_new, fmt):
    root = str(tmp_path / "store")
    with props(store_format_version=fmt, store_chunk_rows=32):
        ds = FileSystemDataStore(root, partition_size=128, device="cpu")
        ds.create_schema("t", "val:Int,dtg:Date,*geom:Point:srid=4326")
        rng = np.random.default_rng(1)
        ds.write("t", {"val": rng.integers(0, 100, 500), "dtg": rng.integers(0, 10**9, 500),
                       "geom": rng.uniform([-180, -90], [180, 90], (500, 2))})
        ds.flush("t")
    env = dict(os.environ, GEOMESA_TPU_FAILPOINTS=f"{failpoint}=kill",
               GEOMESA_TPU_STORE_FORMAT_VERSION=str(fmt), GEOMESA_TPU_STORE_CHUNK_ROWS="32",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, root], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    reopened = FileSystemDataStore(root, partition_size=128, device="cpu")
    fids = set(reopened.query("t", "INCLUDE").batch.fids.tolist())
    assert fids == (set(range(500)) | set(range(10_000, 10_300)) if expect_new else set(range(500)))
    rep = reopened.recover("t")
    assert rep["files"] >= 1  # the unpublished generation, or the uncollected old one
    st = reopened._types["t"]
    kept = {os.path.abspath(reopened._part_path("t", p)) for p in st.partitions}
    on_disk = {os.path.abspath(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(root, "t"))
               for f in fs if f.startswith("part-") or f.endswith(".tmp")}
    assert on_disk == kept
    assert reopened.verify_partitions("t") == []
    if fmt == 2:
        assert reopened.verify_chunk_stats("t") == []


def test_a_failed_writer_fails_the_flush_before_publishing(tmp_path, monkeypatch):
    from geomesa_tpu_torch.store import fs

    root = str(tmp_path / "store")
    ds = FileSystemDataStore(root, partition_size=64, device="cpu")
    ds.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
    ds.write("t", rows("z3", 300, seed=1))
    ds.flush("t")
    gen = ds._types["t"].generation
    real = fs._write_part_file
    calls = []

    def failing(batch, start, stop, path, fsync, chunk_rows=None):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        return real(batch, start, stop, path, fsync, chunk_rows)

    monkeypatch.setattr(fs, "_write_part_file", failing)
    ds.write("t", rows("z3", 100, seed=2), fids=np.arange(1000, 1100))
    with pytest.raises(OSError, match="disk full"):
        ds.flush("t")
    assert ds._types["t"].generation == gen and len(ds._types["t"].pending) == 1
    assert FileSystemDataStore(root, device="cpu").recover("t")["files"] == 0  # nothing left over
    monkeypatch.setattr(fs, "_write_part_file", real)
    assert len(ds.query("t", "INCLUDE")) == 400
    assert not [t for t in threading.enumerate() if t.name.startswith("fs-flush")]


def test_what_the_port_refuses(tmp_path):
    from geomesa_tpu.store.fs import FileSystemDataStore as JFS

    with pytest.raises(NotImplementedError, match="item 7"):
        FileSystemDataStore(str(tmp_path / "a"), mesh=object())
    for enc in ("parquet", "orc"):
        with pytest.raises(ValueError, match="ROADMAP section 3"):
            FileSystemDataStore(str(tmp_path / "b"), encoding=enc)
    with pytest.raises(ValueError, match="unsupported encoding"):
        FileSystemDataStore(str(tmp_path / "b"), encoding="csv")
    jds = JFS(str(tmp_path / "jax"))
    jds.create_schema("t", "count:Int,*geom:Point:srid=4326")
    jds.write("t", {"count": [1, 2], "geom": [(0.0, 0.0), (1.0, 1.0)]})
    jds.flush("t")
    with pytest.raises(ValueError, match="'parquet'"):
        FileSystemDataStore(str(tmp_path / "jax"), device="cpu")


def test_audit_log_equals_the_reference(tmp_path):
    from geomesa_tpu.store.fs import FileSystemDataStore as JFS

    spec = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
    tds = FileSystemDataStore(str(tmp_path / "port"), audit=True, device="cpu")
    jds = JFS(str(tmp_path / "jax"), audit=True)
    for ds in (tds, jds):
        ds.create_schema("t", spec)
        ds.write("t", rows("z3", 300, seed=3))
        ds.query("t", BOX)
        ds.count("t", BOX)
        ds.count("t", "count > 10")
        ds.audit_writer.close()
    got = [(e.store, e.type_name, e.filter, e.hits) for e in tds.audit_writer.read_events()]
    want = [(e.store, e.type_name, e.filter, e.hits) for e in jds.audit_writer.read_events()]
    assert got == want and len(got) == 3
    assert os.path.exists(os.path.join(tds.root, "_queries.jsonl"))


def _part_files(ds) -> "set[str]":
    d = ds._dir("t")
    return {os.path.relpath(os.path.join(dp, f), d)
            for dp, dns, fs in os.walk(d) if not os.path.basename(dp).startswith("_")
            for f in fs if f.startswith("part-")}


def test_a_snapshot_pin_keeps_its_generation_through_gc(tmp_path):
    """A pin file naming the published generation keeps those files
    through the next flush's collection, in both stores; a record that
    escapes the type directory pins nothing; once the pin ages past
    ``snapshot.pin.ttl.s`` the sweep drops it and the files go."""
    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", None, seed=14, labels=False)
        pinned = {}
        for ds in (tds, jds):
            pinned[ds] = _part_files(ds)
            os.makedirs(os.path.join(ds._dir("t"), "_pins"))
            recs = [{"rel": r} for r in sorted(pinned[ds])] + [{"rel": "../escape"}, {"rel": ""}]
            with open(os.path.join(ds._dir("t"), "_pins", "s1.json"), "w") as fh:
                json.dump({"files": recs}, fh)
            ds.write("t", rows("z3", 50, seed=15), fids=np.arange(90_000, 90_050))
            ds.flush("t")
            now = _part_files(ds)
            assert pinned[ds] <= now and now - pinned[ds]  # a new generation beside the pinned one
        assert len(_part_files(tds)) == len(_part_files(jds))
        old = time.time() - 2 * 300.0
        for ds in (tds, jds):
            pin = os.path.join(ds._dir("t"), "_pins", "s1.json")
            os.utime(pin, (old, old))
            ds.write("t", rows("z3", 10, seed=16), fids=np.arange(91_000, 91_010))
            ds.flush("t")
            assert not os.path.exists(pin)
            assert not pinned[ds] & _part_files(ds)
            assert _part_files(ds) == {os.path.relpath(ds._part_path("t", p), ds._dir("t"))
                                       for p in ds._types["t"].partitions}
        same(tds.query("t", "INCLUDE"), jds.query("t", "INCLUDE"))


def test_a_query_hint_cannot_switch_visibility_off(tmp_path):
    """Labeled rows stay hidden from a query without auths whatever hints
    it carries; the per-partition scans defer visibility by an argument
    that no query can set. A caller mutating a result leaves the store's
    answers as they were."""
    from geomesa_tpu_torch.features.batch import VIS_COLUMN
    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    with props(store_chunk_rows=16):
        tds, _ = written(tmp_path, "z3", None, seed=17, labels=True)
    cols = rows("z3", 300, seed=17, labels=True)
    mds = MemoryDataStore(partition_size=64, device="cpu")
    mds.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
    mds.write("t", cols)
    for ds in (tds, mds):
        want = ds.query("t", "INCLUDE")
        labels = ds.query("t", Query(filter="INCLUDE", hints={"auths": ("A", "B", "C")}))
        assert 0 < len(want) < len(labels)
        for hints in ({"internal_scan": True}, {"internal_scan": True, "internal": True}):
            got = ds.query("t", Query(filter="INCLUDE", hints=hints))
            same(got, want)
            assert VIS_COLUMN not in got.batch.columns or not any(got.batch.columns[VIS_COLUMN])
        got = ds.query("t", Query(filter="INCLUDE", hints={"internal_scan": True}))
        got.batch.columns["count"][:] = -1
        same(ds.query("t", "INCLUDE"), want)
