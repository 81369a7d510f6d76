"""The port's streaming live layer (``geomesa_tpu_torch/store/stream.py``)
against the JAX package's (``geomesa_tpu/store/stream.py``), on the CPU,
the port's store on ``device="cpu"``.

- Random sequences on z3 and z2 points (xz2 footprints once) of append,
  query, count, ``process.density``, ``run_stats``, ``compact_now`` and
  reopen, with labeled rows under three auth sets: counts, fids in order
  and columns, density grids, ``run_stats`` JSON, which append sheds at
  ``wal.max.generations``, the manifest's ``wal_watermark`` and
  ``stream_stats`` (byte sizes aside: the payloads differ by design) are
  equal. Grids are exact while runs are live (both row-scan); without runs
  the pushdown answers and grids are held as
  ``tests/test_torch_fs_pushdown.py`` holds them (mass equal, cells within
  rtol 1e-6).
- A compaction beside a query thread: every answer equals the one before.
- ``fail.flush.before_publish`` rolls the compaction back (runs unsealed,
  nothing pending, watermark kept); ``fail.flush.after_publish`` adopts
  the published state; both as in the JAX package.
- The brownout yield against a saturated ``QueryScheduler``, bounded by
  ``stream.stall.s``, as many steps as the JAX package's.
- The delta listener: a ``StreamingDeviceIndex`` takes fresh fids as
  ``"delta"`` without a restage, a ``DeviceIndex`` restages through the
  merged view; counts equal the JAX package's indexes'.
- A WAL payload of the JAX package (Arrow IPC) is refused, naming ROADMAP
  section 3; no query hint switches visibility off through the layer.

The daemons are held in every test (``hold_daemon``): no answer depends on
their timing.
"""

import threading
import time

import numpy as np
import pytest
from _torch_fs_cases import AUTHS, _options, props, random_ecql, rows, same
from _torch_stream_cases import (
    carry,
    layers,
    manifest_watermark,
    reopen,
    same_stream_stats,
)

from geomesa_tpu import failpoints as jfp
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.process.density import density as jdensity
from geomesa_tpu.process.statsproc import run_stats as jrun_stats
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu_torch import failpoints, metrics
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.process.density import density
from geomesa_tpu_torch.process.statsproc import run_stats
from geomesa_tpu_torch.query.plan import Query

ENV = (-60.0, -45.0, 75.0, 50.0)
SETTINGS = dict(wal_max_generations=3, stream_run_rows=40, stream_memtable_rows=1 << 20,
                store_chunk_rows=16)


def _same_grid(got, want, exact):
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert float(got.astype(np.float64).sum()) == float(want.astype(np.float64).sum())
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _sequence(tmp_path, kind, seed, steps):
    rng = np.random.default_rng(seed)
    labels = seed % 2 == 1
    spec = 'Count();MinMax("count")' + (';MinMax("dtg")' if kind == "z3" else "")
    with props(**SETTINGS):
        tl, jl = layers(tmp_path, kind, seed=seed, labels=labels)
        fid = 100_000
        ops = ["append"] * 5 + ["query", "query", "count", "compact", "reopen"]
        if kind != "xz2":
            ops += ["density", "stats"]
        try:
            for step in range(steps):
                op = "append" if step < 3 else ops[rng.integers(len(ops))]
                if op == "append":
                    n = int(rng.integers(5, 36))
                    cols = rows(kind, n, int(rng.integers(1 << 30)), labels=labels)
                    carry(tl, jl, cols, np.arange(fid, fid + n))  # sheds in both, or in neither
                    fid += n
                elif op in ("query", "count"):
                    f = random_ecql(rng, kind)
                    if op == "count":
                        assert tl.count("t", f) == jl.count("t", f), f
                    else:
                        opts = _options(rng, kind)
                        same(tl.query("t", Query(filter=f, **opts)), jl.query("t", JQuery(filter=f, **opts)))
                elif op == "density":
                    f = random_ecql(rng, kind, depth=1)
                    live = bool(tl._runs_snapshot("t"))
                    w = "count" if rng.random() < 0.3 else None
                    got = density(tl, "t", Query(filter=f), Envelope(*ENV), 48, 24, weight_attr=w,
                                  device="cpu")
                    want = jdensity(jl, "t", JQuery(filter=f), JEnvelope(*ENV), 48, 24, weight_attr=w)
                    _same_grid(got, want, exact=live and w is None)
                elif op == "stats":
                    f = random_ecql(rng, kind, depth=1)
                    assert run_stats(tl, "t", Query(filter=f), spec).to_json() == \
                        jrun_stats(jl, "t", JQuery(filter=f), spec).to_json(), f
                elif op == "compact":
                    tl.compact_now("t")
                    jl.compact_now("t")
                    assert manifest_watermark(tl.store) == manifest_watermark(jl.store)
                    assert not tl._runs_snapshot("t")
                else:
                    tl, jl = reopen(tl, jl)
                same_stream_stats(tl, jl)
            for auths in AUTHS:
                same(tl.query("t", Query(filter="INCLUDE", hints={"auths": auths})),
                     jl.query("t", JQuery(filter="INCLUDE", hints={"auths": auths})))
            assert tl.count("t") == jl.count("t")
            tl.compact_now("t")
            jl.compact_now("t")
            assert manifest_watermark(tl.store) == manifest_watermark(jl.store) == \
                tl._streams["t"].wal.next_seq - 1
            same_stream_stats(tl, jl)
            same(tl.query("t", "INCLUDE"), jl.query("t", JQuery(filter="INCLUDE")))
        finally:
            tl.close()
            jl.close()


@pytest.mark.parametrize("kind,seed", [("z3", 1), ("z3", 2), ("z3", 3), ("z2", 4), ("z2", 5), ("xz2", 6)])
def test_random_sequences_equal_the_reference(tmp_path, kind, seed):
    _sequence(tmp_path, kind, seed, steps=14)


def test_sheds_at_the_bound_as_the_reference(tmp_path):
    """Appends of 30 rows into runs of 40: every append opens a run, so the
    fourth sheds at three runs in both, and after a compaction appends flow
    again."""
    with props(**SETTINGS):
        tl, jl = layers(tmp_path, "z3")
        try:
            got = [carry(tl, jl, rows("z3", 30, seed=20 + i), np.arange(1000 + 30 * i, 1030 + 30 * i))
                   is None for i in range(5)]
            assert got == [False, False, False, True, True]
            assert tl._streams["t"].wal.next_seq == jl._streams["t"].wal.next_seq == 3
            assert tl.count("t") == jl.count("t") == 290
            same_stream_stats(tl, jl)
            tl.compact_now("t")
            jl.compact_now("t")
            assert carry(tl, jl, rows("z3", 30, seed=30), np.arange(2000, 2030)) is not None
            assert manifest_watermark(tl.store) == manifest_watermark(jl.store) == 2
            same_stream_stats(tl, jl)
        finally:
            tl.close()
            jl.close()


def test_queries_during_a_compaction_see_every_row_once(tmp_path):
    f = "BBOX(geom, -100, -50, 100, 50)"
    with props(stream_run_rows=64, stream_memtable_rows=1 << 20):
        tl, jl = layers(tmp_path, "z3", n0=400)
        try:
            for i in range(6):
                carry(tl, jl, rows("z3", 50, seed=40 + i), np.arange(5000 + 50 * i, 5050 + 50 * i))
            want = (tl.count("t", f), sorted(tl.query("t", f).batch.fids.tolist()))
            assert want[0] == jl.count("t", f)
            stop, calls, bad = threading.Event(), [], []

            def reader():
                while not stop.is_set():
                    t0 = time.monotonic()
                    got = (tl.count("t", f), sorted(tl.query("t", f).batch.fids.tolist()))
                    calls.append((t0, time.monotonic()))
                    if got != want:
                        bad.append(got[0])

            th = threading.Thread(target=reader, daemon=True)
            th.start()
            deadline = time.monotonic() + 30
            while not calls and time.monotonic() < deadline:
                time.sleep(0.01)
            # the flush sleeps inside the compaction's exclusive section, so
            # the reader's calls wait on it or straddle it
            with failpoints.failpoint_override("fail.flush.after_write", "sleep:300"):
                c0 = time.monotonic()
                tl.compact_now("t")
                c1 = time.monotonic()
            n = len(calls)
            while len(calls) < n + 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            stop.set()
            th.join(timeout=30)
            overlapping = [c for c in calls if c[0] < c1 and c[1] > c0]
            assert not bad and overlapping and not th.is_alive()
            assert not tl._runs_snapshot("t")
            jl.compact_now("t")
            same(tl.query("t", f), jl.query("t", JQuery(filter=f)))
        finally:
            tl.close()
            jl.close()


@pytest.mark.parametrize("failpoint", ["fail.flush.before_publish", "fail.flush.after_publish"])
def test_a_failed_compaction_rolls_back_or_adopts(tmp_path, failpoint):
    with props(stream_run_rows=1 << 20, stream_memtable_rows=1 << 20):
        tl, jl = layers(tmp_path, "z3", n0=300)
        try:
            carry(tl, jl, rows("z3", 40, seed=50), np.arange(9000, 9040))
            wm0 = manifest_watermark(tl.store)
            for lay, fp, err in ((tl, failpoints, failpoints.FailpointError),
                                 (jl, jfp, jfp.FailpointError)):
                with fp.failpoint_override(failpoint, "raise"):
                    if failpoint.endswith("before_publish"):
                        with pytest.raises(err):
                            lay.compact_now("t")
                    else:
                        lay.compact_now("t")  # published: the layer adopts it
                st = lay.store._types["t"]
                assert not st.pending
                runs = lay._runs_snapshot("t")
                if failpoint.endswith("before_publish"):
                    assert st.wal_watermark == wm0 and runs and not any(r.sealed for r in runs)
                else:
                    assert st.wal_watermark == 0 and not runs
            assert manifest_watermark(tl.store) == manifest_watermark(jl.store)
            same_stream_stats(tl, jl)
            assert tl.count("t") == jl.count("t") == 340
            # the next append coalesces into the unsealed run, or opens one
            carry(tl, jl, rows("z3", 10, seed=51), np.arange(9100, 9110))
            same_stream_stats(tl, jl)
            tl, jl = reopen(tl, jl)
            assert tl.count("t") == jl.count("t") == 350
            same(tl.query("t", "INCLUDE"), jl.query("t", JQuery(filter="INCLUDE")))
        finally:
            tl.close()
            jl.close()


def test_the_compactor_yields_to_a_saturated_scheduler(tmp_path):
    from geomesa_tpu_torch.sched.scheduler import QueryScheduler, SchedConfig

    sched = QueryScheduler(SchedConfig(max_queue=8, max_inflight=1))
    gate = threading.Event()
    reqs = [sched.submit(fn=gate.wait, deadline_ms=None)]
    deadline = time.monotonic() + 10
    while sched.queue_pressure()[0] and time.monotonic() < deadline:
        time.sleep(0.01)  # the one worker holds the first request
    reqs += [sched.submit(fn=gate.wait, deadline_ms=None) for _ in range(8)]  # the queue fills
    try:
        assert sched.queue_pressure() == (8, 8)
        with props(stream_compact_yield_ms=10.0, stream_stall_s=0.2, stream_memtable_rows=1 << 20,
                   wal_max_generations=4, stream_run_rows=10):
            tl, jl = layers(tmp_path, "z3", n0=100)
            try:
                tl.scheduler = jl.scheduler = sched  # the JAX layer reads queue_pressure() too
                carry(tl, jl, rows("z3", 10, seed=60), np.arange(7000, 7010))
                from geomesa_tpu import metrics as jmetrics

                yields = []
                for lay, m in ((tl, metrics), (jl, jmetrics)):
                    ts = lay._streams["t"]
                    before = m.stream_compact_yields.value()
                    t0 = time.monotonic()
                    lay._yield_to_serving(ts)
                    spent = time.monotonic() - t0
                    assert 0.09 <= spent < 1.0  # half of stream.stall.s, in 10 ms steps
                    yields.append(m.stream_compact_yields.value() - before)
                assert yields[0] == yields[1] >= 10
                ts = tl._streams["t"]
                ts.kicked = True  # an explicit request never yields
                before = metrics.stream_compact_yields.value()
                tl._yield_to_serving(ts)
                ts.kicked = False
                for i in range(3):  # at the bound (4 runs) it never yields either
                    carry(tl, jl, rows("z3", 10, seed=61 + i), np.arange(7100 + 10 * i, 7110 + 10 * i))
                tl._yield_to_serving(ts)
                assert metrics.stream_compact_yields.value() == before
            finally:
                tl.close()
                jl.close()
    finally:
        gate.set()
        for r in reqs:
            sched.wait(r)
        sched.close()


def test_delta_listeners_feed_resident_indexes_as_the_reference(tmp_path):
    from geomesa_tpu.device_cache import DeviceIndex as JDeviceIndex
    from geomesa_tpu.device_cache import StreamingDeviceIndex as JStreamingDeviceIndex
    from geomesa_tpu_torch.device_cache import DeviceIndex, StreamingDeviceIndex

    with props(stream_run_rows=64, stream_memtable_rows=1 << 20):
        tl, jl = layers(tmp_path, "z3", n0=300, labels=True)
        try:
            carry(tl, jl, rows("z3", 20, seed=70, labels=True), np.arange(8000, 8020))
            idx = {
                "streaming": (StreamingDeviceIndex(tl, "t", capacity=4096, z_planes=True, device="cpu"),
                              JStreamingDeviceIndex(jl, "t", capacity=4096, z_planes=True)),
                "plain": (DeviceIndex(tl, "t", z_planes=True, device="cpu"),
                          JDeviceIndex(jl, "t", z_planes=True)),
            }
            modes = {k: ([], []) for k in idx}
            for k, (ti, ji) in idx.items():
                tl.add_delta_listener(lambda t, b, ti=ti, m=modes[k][0]: m.append(ti.refresh_delta(b)))
                jl.add_delta_listener(lambda t, b, ji=ji, m=modes[k][1]: m.append(ji.refresh_delta(b)))
            for i in range(4):
                carry(tl, jl, rows("z3", 25, seed=71 + i, labels=True),
                      np.arange(8100 + 25 * i, 8125 + 25 * i))
            assert modes["streaming"] == (["delta"] * 4, ["delta"] * 4)
            assert modes["plain"] == (["restage"] * 4, ["restage"] * 4)
            assert idx["streaming"][0].restages == idx["streaming"][1].restages == 1
            box = "BBOX(geom, -100, -50, 100, 50) AND dtg DURING 2020-01-02T00:00:00Z/2020-01-05T00:00:00Z"
            for (ti, ji) in idx.values():
                assert len(ti) == len(ji) == tl.count("t", Query(filter="INCLUDE", hints={
                    "auths": ("A", "B", "C")}))
                for auths in AUTHS:
                    for loose in (False, True):
                        assert ti.count(box, loose=loose, auths=auths) == ji.count(
                            box, loose=loose, auths=auths), (auths, loose)
                    assert ti.count(box, auths=auths) == tl.count("t", Query(filter=box, hints={
                        "auths": auths}))
            tl.compact_now("t")
            assert idx["streaming"][0].count(box) == tl.count("t", box)
        finally:
            tl.close()
            jl.close()


def test_a_foreign_wal_payload_is_refused(tmp_path):
    """The JAX package's layer writes Arrow IPC payloads; the port's never
    reads one as a batch."""
    from geomesa_tpu_torch.store.fs import FileSystemDataStore
    from geomesa_tpu_torch.store.stream import StreamingStore
    from geomesa_tpu_torch.store.wal import WriteAheadLog

    tl, jl = layers(tmp_path, "z3", n0=50)
    try:
        jl.append("t", rows("z3", 10, seed=80), fids=np.arange(600, 610))
        arrow = next(iter(jl._streams["t"].wal.read_from(-1)))[1]
    finally:
        jl.close()
        tl.close()
    wal = WriteAheadLog(tl._wal_dir("t"))
    wal.append(arrow)
    wal.close()
    with pytest.raises(ValueError, match="ROADMAP.md section 3"):
        StreamingStore(FileSystemDataStore(tl.store.root, partition_size=64, device="cpu"))


def test_no_query_hint_switches_visibility_off_through_the_layer(tmp_path):
    from geomesa_tpu_torch.features.batch import VIS_COLUMN

    with props(stream_run_rows=64, stream_memtable_rows=1 << 20):
        tl, jl = layers(tmp_path, "z3", n0=200, labels=True)
        try:
            carry(tl, jl, rows("z3", 60, seed=90, labels=True), np.arange(3000, 3060))
            assert tl._runs_snapshot("t")
            want = tl.query("t", "INCLUDE")
            every = tl.query("t", Query(filter="INCLUDE", hints={"auths": ("A", "B", "C")}))
            assert 0 < len(want) < len(every) == 260
            for hints in ({"internal_scan": True}, {"internal_scan": True, "internal": True}):
                for opts in ({}, {"sort_by": "count", "max_features": 500}):
                    got = tl.query("t", Query(filter="INCLUDE", hints=hints, **opts))
                    assert sorted(got.batch.fids.tolist()) == sorted(want.batch.fids.tolist())
                    assert VIS_COLUMN not in got.batch.columns or not any(got.batch.columns[VIS_COLUMN])
                assert tl.count("t", Query(filter="INCLUDE", hints=hints)) == len(want)
            same(want, jl.query("t", JQuery(filter="INCLUDE")))
        finally:
            tl.close()
            jl.close()
