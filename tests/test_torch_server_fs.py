"""Port parity for the server over file-system stores: the streaming live
layer's POST ``/append`` and the degradation ladder, ``geomesa_tpu_torch``
against ``geomesa_tpu``, each server over its own store under ``tmp_path``
fed the same seeded rows.

- ``/append`` acks the reference's ``{"acked", "seq"}``; the rows count at
  once (resident: through the delta listener, ``refresh_delta`` mode
  ``delta``, no restage); 413 past ``stream.append.max.bytes``; 429 with
  ``Retry-After`` at ``wal.max.generations``; 400 without the live layer.
- ``fail.device.launch`` over resident requests: the same answers and
  ``X-Degraded`` reasons (``device-launch-failed``, then
  ``device-breaker-open`` once the breaker opens), ``/readyz`` reporting
  the breaker, and the half-open probe closing it after the disarm.
- ``fail.resident.launch`` (the port's own point) fails the resident rung
  alone: the store rung answers as the reference does unfaulted.
- A partition whose checksum fails is skipped and the answer stamped
  ``partition-unavailable`` when a request's collector is installed (the
  server, or ``collect_degraded`` around a direct query), as the reference
  does; without one both raise (``test_torch_fs_durability.py``).
- A draining shutdown, then a reopen that replays the appended rows.
"""

import json
import time

import numpy as np
import pytest
from _torch_fs_cases import pair, props, rows, same
from _torch_server_cases import BOX, Q1, fetch, q, reset_singletons, serving

from geomesa_tpu import failpoints as jfp
from geomesa_tpu import resilience as jres
from geomesa_tpu_torch import failpoints, metrics, resilience


def _stores(tmp_path, n=600, seed=21, psize=64):
    tds, jds = pair(str(tmp_path), "z3", psize=psize)
    cols = rows("z3", n, seed)
    for ds in (tds, jds):
        ds.write("t", cols)
        ds.flush("t")
    return tds, jds


def _body(n, seed, fid0):
    c = rows("z3", n, seed)
    return {"columns": {"name": [None if v is None else str(v) for v in c["name"]],
                        "count": [int(v) for v in c["count"]],
                        "val": [float(v) for v in c["val"]],
                        "dtg": [int(v) for v in c["dtg"]],
                        "geom": [[float(x), float(y)] for x, y in c["geom"]]},
            "fids": [f"a{fid0 + i}" for i in range(n)]}


def _hold(server):
    server.stream_layer._compact_due = lambda ts: False


def _post(base, path, body):
    return fetch(base, path, method="POST", body=body)


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    reset_singletons(tmp_path / "flightrec")
    yield
    reset_singletons()


@pytest.mark.parametrize("resident", [False, True], ids=["store", "resident"])
def test_append_acks_and_counts_as_the_reference(tmp_path, resident):
    tds, jds = _stores(tmp_path)
    with serving(tds, jds, resident=resident, sched=True, stream=True) as (purl, jurl, ps, js):
        _hold(ps)
        _hold(js)
        for base in (purl, jurl):  # stage the resident index before the appends
            assert fetch(base, f"/count/gdelt?cql={q(BOX)}")[0] == 404
            assert fetch(base, f"/count/t?cql={q(BOX)}")[0] == 200
        delta0 = metrics.stream_delta_refreshes.value(mode="delta")
        for i in range(4):
            body = _body(40, 100 + i, 1000 * i)
            got, want = _post(purl, "/append/t", body), _post(jurl, "/append/t", body)
            assert got[0] == want[0] == 200
            assert json.loads(got[2]) == json.loads(want[2]) == {"acked": 40, "seq": i}
            for path in (f"/count/t?cql={q(Q1)}", f"/count/t?cql={q(BOX)}&loose=1", "/count/t"):
                a, b = fetch(purl, path), fetch(jurl, path)
                assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), path
        if resident:
            assert metrics.stream_delta_refreshes.value(mode="delta") - delta0 == 4
            di = ps.RequestHandlerClass._resident_cache["t"]
            assert di.restages == 1  # the first touch only
        a = json.loads(fetch(purl, "/stats/stream")[2])
        b = json.loads(fetch(jurl, "/stats/stream")[2])
        assert set(a) == set(b)
        bad = {"columns": {"name": ["x"]}}
        got, want = _post(purl, "/append/t", bad), _post(jurl, "/append/t", bad)
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2]))
        assert got[0] == 400
        got, want = _post(purl, "/append/nope", _body(2, 1, 0)), _post(jurl, "/append/nope", _body(2, 1, 0))
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2])) and got[0] == 404


def test_append_limits_answer_as_the_reference(tmp_path):
    tds, jds = _stores(tmp_path, n=200)
    with props(stream_append_max_bytes=2000, wal_max_generations=2, stream_run_rows=8):
        with serving(tds, jds, sched=True, stream=True) as (purl, jurl, ps, js):
            _hold(ps)
            _hold(js)
            big = _body(200, 7, 0)
            got, want = _post(purl, "/append/t", big), _post(jurl, "/append/t", big)
            assert got[0] == want[0] == 413
            assert json.loads(got[2]) == json.loads(want[2])
            codes = []
            for i in range(4):
                body = _body(10, 30 + i, 100 * i)
                got, want = _post(purl, "/append/t", body), _post(jurl, "/append/t", body)
                assert got[0] == want[0]
                assert (got[1].get("Retry-After") is None) == (want[1].get("Retry-After") is None)
                if got[0] == 200:
                    assert json.loads(got[2]) == json.loads(want[2])
                codes.append(got[0])
            assert codes[0] == 200 and 429 in codes
            assert int(fetch(purl, "/count/t")[2].split(b":")[1].strip(b" }")) == \
                int(fetch(jurl, "/count/t")[2].split(b":")[1].strip(b" }"))
    with serving(*_stores(tmp_path / "plain", n=50)) as (purl, jurl, _, _):
        got, want = _post(purl, "/append/t", _body(2, 1, 0)), _post(jurl, "/append/t", _body(2, 1, 0))
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2])) and got[0] == 400


def test_device_launch_failures_walk_the_ladder_as_the_reference(tmp_path):
    tds, jds = _stores(tmp_path, n=800, seed=23)
    paths = [f"/count/t?cql={q(Q1)}", f"/features/t?cql={q(BOX)}&maxFeatures=20",
             f"/density/t?cql={q(Q1)}&bbox=-180,-90,180,90&width=8&height=4",
             f"/stats/t?cql={q(BOX)}&stats=Count()"]
    with props(resilience_backoff_ms=0.0, resilience_breaker_failures=3,
               resilience_breaker_cooldown_s=60.0):
        with serving(tds, jds, resident=True, sched=True) as (purl, jurl, _, _):
            for base in (purl, jurl):
                assert fetch(base, "/count/t")[0] == 200  # staged before arming
            seen = []
            with failpoints.failpoint_override("fail.device.launch", "raise"), \
                    jfp.failpoint_override("fail.device.launch", "raise"):
                for i in range(8):
                    path = paths[i % len(paths)]
                    a, b = fetch(purl, path), fetch(jurl, path)
                    assert a[0] == b[0] == 200, (path, a[2][:200], b[2][:200])
                    assert a[1].get("X-Degraded") == b[1].get("X-Degraded"), path
                    da, db = json.loads(a[2]), json.loads(b[2])
                    if "features" in da:
                        da = [f["id"] for f in da["features"]]
                        db = [f["id"] for f in db["features"]]
                    assert da == db, path
                    seen.append(a[1].get("X-Degraded"))
                ra, rb = json.loads(fetch(purl, "/readyz")[2]), json.loads(fetch(jurl, "/readyz")[2])
                assert ra["breakers"]["device"]["state"] == rb["breakers"]["device"]["state"] == "open"
                assert ra["degraded_domains"] == rb["degraded_domains"] == ["device"]
            assert "device-launch-failed" in seen[0]
            assert any(s and s.startswith("device-breaker-open") for s in seen)
            # the breakers read their cooldown on every use: at 0 the next
            # request is the half-open probe
            with props(resilience_breaker_cooldown_s=0.0):
                a, b = fetch(purl, paths[0]), fetch(jurl, paths[0])
            assert a[0] == b[0] == 200 and a[2] == b[2]
            for path in paths[:2]:
                a, b = fetch(purl, path), fetch(jurl, path)
                assert a[0] == b[0] == 200
                assert a[1].get("X-Degraded") is None and b[1].get("X-Degraded") is None
            ra, rb = json.loads(fetch(purl, "/readyz")[2]), json.loads(fetch(jurl, "/readyz")[2])
            assert ra["breakers"]["device"]["state"] == rb["breakers"]["device"]["state"] == "closed"
            assert ra["breakers"]["device"]["opens"] == rb["breakers"]["device"]["opens"] >= 1


def test_a_resident_launch_failure_falls_to_the_store_rung(tmp_path):
    """``fail.resident.launch`` (the port's own point) fails the resident
    rung only: the store rung answers as the reference's server answers
    without a fault, stamped ``device-launch-failed`` alone, and nothing
    of the runner's host rung is noted."""
    tds, jds = _stores(tmp_path, n=800, seed=24)
    paths = [f"/count/t?cql={q(Q1)}", f"/features/t?cql={q(BOX)}&maxFeatures=20",
             f"/density/t?cql={q(Q1)}&bbox=-180,-90,180,90&width=8&height=4"]
    with props(resilience_backoff_ms=0.0, resilience_breaker_failures=100):
        with serving(tds, jds, resident=True, sched=True) as (purl, jurl, _, _):
            assert fetch(purl, "/count/t")[0] == 200  # staged before arming
            with failpoints.failpoint_override("fail.resident.launch", "raise"):
                for path in paths:
                    a, b = fetch(purl, path), fetch(jurl, path)
                    assert a[0] == b[0] == 200, (path, a[2][:200])
                    assert a[1].get("X-Degraded") == "device-launch-failed", path
                    assert b[1].get("X-Degraded") is None
                    da, db = json.loads(a[2]), json.loads(b[2])
                    if "features" in da:
                        da = sorted(f["id"] for f in da["features"])
                        db = sorted(f["id"] for f in db["features"])
                    assert da == db, path


def _flip_one(tds, jds, box):
    """Flip a byte in the same partition of both stores, one the box's
    plan touches; returns its pid."""
    plan = tds.plan("t", box)
    victim = sorted(p.pid for p in tds._pruned_parts("t", plan))[0]
    for ds in (tds, jds):
        p = next(p for p in ds._types["t"].partitions if p.pid == victim)
        path = ds._part_path("t", p)
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
    return victim


def test_an_unreadable_partition_is_skipped_and_stamped_with_a_collector(tmp_path):
    from geomesa_tpu.store.fs import FileSystemDataStore as JFS
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    tds, jds = _stores(tmp_path, n=600, seed=25)
    _flip_one(tds, jds, BOX)
    with props(store_verify="always"):
        t2 = FileSystemDataStore(tds.root, partition_size=64, device="cpu")
        j2 = JFS(jds.root, partition_size=64)
        with resilience.collect_degraded() as reasons:
            got = t2.query("t", BOX)
        with jres.collect_degraded() as jreasons:
            want = j2.query("t", BOX)
        same(got, want)
        assert reasons == jreasons == ["partition-unavailable"]
        assert json.loads(json.dumps(resilience.snapshot()))["partition_open"] == \
            jres.snapshot()["partition_open"]
        with serving(t2, j2) as (purl, jurl, _, _):
            for path in (f"/features/t?cql={q(BOX)}", f"/count/t?cql={q(BOX)}&auths=A"):
                a, b = fetch(purl, path), fetch(jurl, path)
                assert a[0] == b[0] == 200
                assert a[1].get("X-Degraded") == b[1].get("X-Degraded") == "partition-unavailable"
                da, db = json.loads(a[2]), json.loads(b[2])
                if "features" in da:
                    da = [f["id"] for f in da["features"]]
                    db = [f["id"] for f in db["features"]]
                assert da == db


def test_admin_shutdown_drains_and_a_reopen_replays_the_appends(tmp_path):
    from geomesa_tpu.store.fs import FileSystemDataStore as JFS
    from geomesa_tpu_torch.server import serve_background
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    tds, jds = _stores(tmp_path, n=300, seed=27)
    with serving(tds, jds, stream=True) as (purl, jurl, ps, js):
        _hold(ps)
        _hold(js)
        for i in range(3):
            body = _body(25, 50 + i, 100 * i)
            assert _post(purl, "/append/t", body)[0] == _post(jurl, "/append/t", body)[0] == 200
        want = json.loads(fetch(jurl, f"/count/t?cql={q(BOX)}")[2])
        assert json.loads(fetch(purl, f"/count/t?cql={q(BOX)}")[2]) == want
        got, ref = _post(purl, "/admin/shutdown", {}), _post(jurl, "/admin/shutdown", {})
        assert (got[0], json.loads(got[2])) == (ref[0], json.loads(ref[2])) == (200, {"draining": True})
        for _ in range(100):
            if ps.draining.is_set():
                break
            time.sleep(0.01)
        assert ps.draining.is_set()
    t2 = FileSystemDataStore(tds.root, partition_size=64, device="cpu")
    server, _ = serve_background(t2, stream=True, resident=True)
    try:
        base = "http://%s:%d" % server.server_address[:2]
        assert json.loads(fetch(base, f"/count/t?cql={q(BOX)}")[2]) == want
        assert json.loads(fetch(base, "/count/t")[2])["count"] == 300 + 75
    finally:
        server.shutdown()
        server.server_close()
    jb = JFS(jds.root, partition_size=64)
    assert jb.count("t", "INCLUDE") == 300  # the reference's rows wait in its WAL too
