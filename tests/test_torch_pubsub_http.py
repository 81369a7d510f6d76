"""The push tier over HTTP: the port's server (``geomesa_tpu_torch.server``,
stores on ``device="cpu"``) beside the JAX package's, each over its own
file-system store with the live layer (``stream=True``), the same requests
sent to both; the HTTP cases of ``tests/test_pubsub.py``.

- POST / GET (SSE) / DELETE ``/subscribe/<type>``: the same responses (ids
  aside), the same match events (seq, fids), ``/stats/pubsub`` and the
  ``/stats`` roll-up equal, the stream ends ``cancelled``.
- Heartbeats outlive the idle keep-alive reaper; ``from=`` and
  ``Last-Event-ID`` resume exactly once; a cursor below the compacted tail
  answers 410; a drain ends open streams with ``shutdown``.
- Formats: the SSE bytes and the BIN bytes equal the JAX package's (the
  subscription ids aside); ``f=arrow`` answers 406 in the port (ROADMAP
  section 3) where the JAX package streams Arrow; an unknown ``f`` 400.
- Errors: 404 for an unknown type or subscription, 400 for a bad body, a
  missing id, or a server without the live layer.
- ``GET /wal/_pubsub``: the registry ship's headers and records equal
  (ids aside); the records unpack with ``pack_record``'s framing.
- The ``subs`` CLI lists and cancels as the JAX package's does, and
  ``load-driver --subscribe K --append-every N`` self-serves the mixed leg.
"""

import json
import re
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest
from _torch_fs_cases import props
from _torch_server_cases import fetch, reset_singletons

from geomesa_tpu.server import serve_background as jserve
from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu_torch.server import serve_background
from geomesa_tpu_torch.store.fs import FileSystemDataStore

SPEC = "val:Int,dtg:Date,*geom:Point:srid=4326"


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    reset_singletons(tmp_path / "flightrec")
    yield
    reset_singletons()


def _url(server) -> str:
    return "http://%s:%s" % server.server_address[:2]


@contextmanager
def _servers(tmp_path, stream=True, **extra):
    """Both servers over fresh fs stores of type ``t`` (SPEC), the live layer
    on, heartbeats every 0.2 s and the idle reaper at 0.5 s."""
    roots = str(tmp_path / "port"), str(tmp_path / "jax")
    tds = FileSystemDataStore(roots[0], partition_size=128, device="cpu")
    jds = JFS(roots[1], partition_size=128)
    for ds in (tds, jds):
        ds.create_schema("t", SPEC)
    with props(sub_heartbeat_s=0.2, http_keepalive_s=0.5, **extra):
        ps, _ = serve_background(FileSystemDataStore(roots[0], partition_size=128, device="cpu"),
                                 stream=stream)
        try:
            js, _ = jserve(JFS(roots[1], partition_size=128), stream=stream)
        except BaseException:
            ps.shutdown()
            ps.server_close()
            raise
        try:
            yield _url(ps), _url(js), ps, js
        finally:
            for s in (ps, js):
                s.shutdown()
                s.server_close()


def _post(base, path, doc):
    return fetch(base, path, method="POST", body=doc)


def _ok(res):
    st, _, body = res
    assert st == 200, body[:300]
    return json.loads(body)


def _append_doc(fids, x=10.0, vals=None):
    n = len(fids)
    return {"columns": {"val": list(vals) if vals is not None else list(range(n)),
                        "dtg": [1000 + i for i in range(n)], "geom": [[x, x]] * n},
            "fids": list(fids)}


def _wait(pred, timeout_s=20.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class _SSEReader:
    """A background SSE consumer: (seq, fids) match events, keepalive
    counts, end reasons and the raw bytes of one connection. ``until``
    (a predicate on the reader) ends the read by itself: a BIN stream sends
    no heartbeat that would wake a reader to see ``stop``."""

    def __init__(self, base, sub_id, from_seq=None, headers=None, fmt=None, until=None):
        url = f"{base}/subscribe/t?id={sub_id}"
        if from_seq is not None:
            url += f"&from={from_seq}"
        if fmt is not None:
            url += f"&f={fmt}"
        self.matches: list = []
        self.keepalives = 0
        self.ends: list = []
        self.raw = b""
        self.error = None
        self.ctype = None
        self._stop = False
        self._resp = None
        self._until = until
        self._thread = threading.Thread(target=self._run, args=(url, headers or {}), daemon=True)
        self._thread.start()

    def _run(self, url, headers):
        try:
            self._resp = urllib.request.urlopen(urllib.request.Request(url, headers=headers),
                                                timeout=30)
            self.ctype = self._resp.headers["Content-Type"]
            buf = b""
            while not self._stop:
                chunk = self._resp.read1(65536)
                if not chunk:
                    break
                self.raw += chunk
                if self._until is not None:
                    if self._until(self):
                        break
                    continue
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    self._frame(frame)
            self._resp.close()
        except Exception as e:  # noqa: BLE001 - surfaced through .error
            self.error = e

    def _frame(self, frame):
        if frame.startswith(b":keepalive"):
            self.keepalives += 1
        elif b"event: end" in frame:
            for ln in frame.split(b"\n"):
                if ln.startswith(b"data: "):
                    self.ends.append(json.loads(ln[6:]))
        elif b"event: match" in frame:
            seq, fids = None, []
            for ln in frame.split(b"\n"):
                if ln.startswith(b"id: "):
                    seq = int(ln[4:])
                elif ln.startswith(b"data: "):
                    doc = json.loads(ln[6:])
                    fids = [int(f["id"]) for f in doc["features"]]
                    assert doc["seq"] == seq
            self.matches.append((seq, fids))

    def stop(self):
        self._stop = True
        try:
            if self._resp is not None:
                self._resp.close()
        except Exception:  # noqa: BLE001 - closing a torn socket
            pass
        self._thread.join(10)


def _norm_stats(doc, ids):
    """/stats/pubsub with subscription ids mapped to their registration
    index and the registry's directory dropped."""
    doc = json.loads(json.dumps(doc))
    doc["registry"]["wal"].pop("dir", None)
    for d in doc["subscriptions"]:
        d["id"] = ids.index(d["id"])
    return doc


def test_subscribe_stream_and_cancel_as_the_reference(tmp_path):
    with _servers(tmp_path) as (purl, jurl, ps, js):
        out = {}
        for base in (purl, jurl):
            subs = [_ok(_post(base, "/subscribe/t?tenant=alice", {"bbox": [0, 0, 20, 20],
                                                                   "cql": "val > 5"})),
                    _ok(_post(base, "/subscribe/t?tenant=bob&auths=A",
                              {"dwithin": {"x": 10, "y": 10, "distance": 1}}))]
            ids = [s["id"] for s in subs]
            rd = _SSEReader(base, ids[0])
            try:
                _wait(lambda: rd.keepalives, msg="the stream is armed")
                acks = [_ok(_post(base, "/append/t", _append_doc([7, 8], vals=[3, 9]))),
                        _ok(_post(base, "/append/t", _append_doc([9], x=50.0, vals=[30])))]
                _wait(lambda: rd.matches, msg="a live SSE match")
                st = _norm_stats(_ok(fetch(base, "/stats/pubsub")), ids)
                roll = _ok(fetch(base, "/stats"))["pubsub"]
                cancelled = [_ok(fetch(base, f"/subscribe/t?id={ids[0]}", method="DELETE"))]
                _wait(lambda: rd.ends, msg="the end frame after the cancel")
                again = fetch(base, f"/subscribe/t?id={ids[0]}", method="DELETE")[0]
                st2 = _norm_stats(_ok(fetch(base, "/stats/pubsub")), ids)
            finally:
                rd.stop()
            for s in subs:
                assert len(s.pop("id")) == 12
            out[base] = (subs, acks, rd.matches, st, roll["enabled"], [c == {"cancelled": ids[0]}
                                                                       for c in cancelled],
                         rd.ends, again, st2)
        assert out[purl] == out[jurl]
        assert out[purl][2] == [(0, [8])] and out[purl][6] == [{"reason": "cancelled"}]
        assert out[purl][7] == 404 and len(out[purl][8]["subscriptions"]) == 1


def test_heartbeats_outlive_the_idle_socket_reaper(tmp_path):
    with _servers(tmp_path) as (purl, jurl, _, _):
        got = []
        for base in (purl, jurl):
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            rd = _SSEReader(base, sub["id"])
            try:
                time.sleep(1.6)  # over 3x the idle reap timeout, no traffic
                assert rd.error is None and rd.keepalives >= 3
                out = _ok(_post(base, "/append/t", _append_doc([1])))
                _wait(lambda: rd.matches, msg="a match after the quiet window")
                got.append(rd.matches == [(out["seq"], [1])])
            finally:
                rd.stop()
        assert got == [True, True]


def test_from_and_last_event_id_resume_exactly_once(tmp_path):
    with _servers(tmp_path) as (purl, jurl, _, _):
        out = []
        for base in (purl, jurl):
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            seqs = [_ok(_post(base, "/append/t", _append_doc([i])))["seq"] for i in range(4)]
            rd = _SSEReader(base, sub["id"], from_seq=seqs[0])
            try:
                _wait(lambda: len(rd.matches) == 3, msg="the replay above the cursor")
            finally:
                rd.stop()
            rd2 = _SSEReader(base, sub["id"], headers={"Last-Event-ID": str(seqs[2])})
            try:
                _wait(lambda: rd2.matches, msg="the Last-Event-ID resume")
                live = _ok(_post(base, "/append/t", _append_doc([9])))["seq"]
                _wait(lambda: len(rd2.matches) == 2, msg="the live event after the replay")
                time.sleep(0.3)
            finally:
                rd2.stop()
            assert rd2.ctype.startswith("text/event-stream")
            out.append((rd.matches, rd2.matches, live))
        assert out[0] == out[1]
        assert out[0] == ([(1, [1]), (2, [2]), (3, [3])], [(3, [3]), (4, [9])], 4)


def test_a_cursor_below_the_compacted_tail_answers_410(tmp_path, monkeypatch):
    with _servers(tmp_path) as (purl, jurl, ps, js):
        got = []
        for base, srv in ((purl, ps), (jurl, js)):
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            for i in range(3):
                _post(base, "/append/t", _append_doc([i]))
            monkeypatch.setattr(srv.pubsub.stream._ts("t").wal, "first_seq", lambda: 2)
            st, _, body = fetch(base, f"/subscribe/t?id={sub['id']}&from=0")
            got.append((st, json.loads(body)))
        assert got[0] == got[1] and got[0][0] == 410


def _sse_norm(raw: bytes, sub_id: str) -> bytes:
    return raw.replace(sub_id.encode(), b"<id>")


def test_push_formats_as_the_reference(tmp_path):
    """SSE and BIN bytes equal the JAX package's; Arrow is 406 in the port."""
    with _servers(tmp_path) as (purl, jurl, _, _):
        raw = {}
        for base in (purl, jurl):
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            _post(base, "/append/t", _append_doc([1, 2], x=5.0, vals=[4, 5]))
            _post(base, "/append/t", _append_doc([3], x=6.0))
            readers = {"geojson": _SSEReader(base, sub["id"], from_seq=-1, fmt="geojson"),
                       "bin": _SSEReader(base, sub["id"], from_seq=-1, fmt="bin",
                                         until=lambda r: len(r.raw) >= 3 * 16)}
            try:
                _wait(lambda: len(readers["geojson"].matches) == 2, msg="the SSE replay")
                _wait(lambda: len(readers["bin"].raw) >= 3 * 16, msg="the BIN replay")
            finally:
                for r in readers.values():
                    r.stop()
            head = readers["geojson"].raw.split(b":keepalive")[0]
            raw[base] = (_sse_norm(head, sub["id"]), readers["bin"].raw[:48],
                         readers["geojson"].ctype, readers["bin"].ctype)
            bad = fetch(base, f"/subscribe/t?id={sub['id']}&f=nope")
            raw[base] += (bad[0], json.loads(bad[2]))
            arrow = fetch(base, f"/subscribe/t?id={sub['id']}&from=-1&f=arrow") if base == purl \
                else None
            raw[base] += ((arrow[0], b"ROADMAP" in arrow[2]) if arrow else None,)
        assert raw[purl][:6] == raw[jurl][:6]
        assert raw[purl][2] == "text/event-stream" and raw[purl][3] == "application/vnd.geomesa.bin"
        assert raw[purl][4] == 400 and raw[purl][6] == (406, True)
        assert b"id: 0\nevent: match" in raw[purl][0] and b"id: 1\nevent: match" in raw[purl][0]


def test_subscribe_errors_as_the_reference(tmp_path):
    with _servers(tmp_path) as (purl, jurl, _, _):
        for path, doc in (("/subscribe/missing", {"bbox": [0, 0, 1, 1]}), ("/subscribe/t", {}),
                          ("/subscribe/t", {"bbox": [9, 9, 0, 0]}),
                          ("/subscribe/t", {"cql": "val >"}), ("/subscribe/t/x", {"bbox": [0, 0, 1, 1]})):
            a, b = _post(purl, path, doc), _post(jurl, path, doc)
            assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), path
            assert a[0] in (400, 404)
        for path, method in (("/subscribe/t?id=nope", "GET"), ("/subscribe/t", "GET"),
                             ("/subscribe/missing?id=x", "GET"), ("/subscribe/t", "DELETE"),
                             ("/subscribe/t?id=nope", "DELETE"), ("/nope", "DELETE")):
            a, b = fetch(purl, path, method=method), fetch(jurl, path, method=method)
            assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), path
            assert a[0] in (400, 404)


def test_a_server_without_the_live_layer_refuses_as_the_reference(tmp_path):
    with _servers(tmp_path, stream=False) as (purl, jurl, _, _):
        for path, method, body in (("/subscribe/t", "POST", {"bbox": [0, 0, 1, 1]}),
                                   ("/subscribe/t?id=x", "GET", None),
                                   ("/subscribe/t?id=x", "DELETE", None),
                                   ("/stats/pubsub", "GET", None), ("/wal/_pubsub", "GET", None)):
            a = fetch(purl, path, method=method, body=body)
            b = fetch(jurl, path, method=method, body=body)
            assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), path
        assert json.loads(fetch(purl, "/stats/pubsub")[2]) == {"enabled": False}
        assert "pubsub" not in json.loads(fetch(purl, "/stats")[2])


def _records(data: bytes) -> list:
    out, off = [], 0
    while off < len(data):
        magic, seq, length, _crc = struct.unpack_from("<IQII", data, off)
        assert magic == 0x474D5741
        out.append((seq, json.loads(data[off + 20:off + 20 + length])))
        off += 20 + length
    return out


def test_the_registry_ship_as_the_reference(tmp_path):
    from geomesa_tpu_torch.store.wal import pack_record

    with _servers(tmp_path) as (purl, jurl, ps, _):
        got = {}
        for base in (purl, jurl):
            ids = [_ok(_post(base, "/subscribe/t?tenant=x", d))["id"] for d in (
                {"bbox": [0, 0, 5, 5]}, {"cql": "val > 3"}, {"dwithin": {"x": 1, "y": 1, "distance": 2}})]
            fetch(base, f"/subscribe/t?id={ids[1]}", method="DELETE")
            ships = []
            for frm in (0, 2, 9):
                st, h, data = fetch(base, f"/wal/_pubsub?from={frm}")
                recs = _records(data)
                text = json.dumps(recs)
                for i, sid in enumerate(ids):
                    text = text.replace(sid, f"<{i}>")
                ships.append((st, h["Content-Type"], h["X-Wal-Next-Seq"], h["X-Wal-Watermark"],
                              h["X-Replica-Role"], h["X-Replica-Epoch"], text))
            got[base] = ships
        assert got[purl] == got[jurl]
        assert got[purl][0][2] == "4" and len(json.loads(got[purl][0][6])) == 4
        assert json.loads(got[purl][2][6]) == []
        wal = ps.pubsub.registry.wal
        assert fetch(purl, "/wal/_pubsub")[2] == b"".join(
            pack_record(s, p) for s, p in wal.read_from(-1))


def test_a_drain_ends_open_streams(tmp_path):
    with _servers(tmp_path) as (purl, jurl, ps, js):
        readers = []
        for base in (purl, jurl):
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            readers.append(_SSEReader(base, sub["id"]))
        _wait(lambda: all(r.keepalives for r in readers), msg="both streams armed")
        for srv in (ps, js):
            srv.pubsub.close()
        _wait(lambda: all(r.ends for r in readers), msg="the end frames")
        for r in readers:
            r.stop()
        assert [r.ends for r in readers] == [[{"reason": "shutdown"}]] * 2


def _cli(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_subs_cli_lists_and_cancels_as_the_reference(tmp_path, capsys):
    from geomesa_tpu.tools.cli import main as jmain
    from geomesa_tpu_torch.tools.cli import main

    with _servers(tmp_path) as (purl, jurl, _, _):
        outs = []
        for base, fn in ((purl, main), (jurl, jmain)):
            subs = [_ok(_post(base, "/subscribe/t?tenant=ops", {"bbox": [0, 0, 20, 20], "cql": "val > 5"})),
                    _ok(_post(base, "/subscribe/t?tenant=dev",
                              {"dwithin": {"x": 1.5, "y": 2, "distance": 3}}))]
            ids = [s["id"] for s in subs]
            listed = _cli(fn, ["subs", "--url", base], capsys)
            one = _cli(fn, ["subs", "--url", base, "--id", ids[1]], capsys)
            cancel = _cli(fn, ["subs", "--url", base, "--id", ids[0], "--cancel"], capsys)
            after = _cli(fn, ["subs", "--url", base], capsys)
            with pytest.raises(SystemExit):
                fn(["subs", "--url", base, "--id", "nope"])
            capsys.readouterr()
            text = "\n".join((listed, one, cancel, after))
            for i, sid in enumerate(ids):
                text = text.replace(sid, f"<{i}>")
            outs.append(text)
        assert outs[0] == outs[1]
        assert "ops" in outs[0] and "val > 5" in outs[0] and "dwithin(1.5,2,3)" in outs[0]
        assert re.search(r"subscriptions: 1\b", outs[0])


def test_load_driver_holds_subscriptions_through_appends(tmp_path):
    """``load-driver --subscribe 2 --append-every 2`` self-serves the mixed
    leg in a child process: every acked append reaches both world-bbox
    subscribers."""
    import os

    from _torch_fs_cases import rows

    root = str(tmp_path / "root")
    ds = FileSystemDataStore(root, partition_size=128, device="cpu")
    ds.create_schema("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
    ds.write("t", rows("z3", 300, 5))
    ds.flush("t")
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMESA_TPU_")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.tools", "--root", root, "--device", "cpu",
         "load-driver", "-f", "t", "--threads", "1", "--requests", "6", "--append-every", "2",
         "--append-rows", "4", "--subscribe", "2", "--tenants", "1"],
        cwd=env["PYTHONPATH"], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    rep = json.loads("\n".join(lines[: lines.index("}") + 1]))
    assert rep["appends"] == {"attempted": 3, "acked_rows": 12, "shed": 0, "errors": 0}
    assert rep["ok"] == 3 and rep["errors"] == 0
    assert rep["pubsub"] == {"subscriptions": 2, "events_per_sub": [3, 3], "total_events": 6}
    assert "sub0" in out.stdout
    assert np.isfinite(rep["p50_ms"])


def test_concurrent_appends_with_a_scheduler_match_without_waiting(tmp_path):
    """Appends run on the scheduler's workers, and each match runs on the
    append's worker: eight concurrent appends with a subscription all ack
    at once, with no match fault, and each reaches the stream. (The JAX
    package's matcher asks the scheduler for a second worker from there:
    with both workers so held, its appends wait out the 30 s deadline and
    answer 504, ROADMAP section 3.)"""
    from geomesa_tpu_torch import sched as tsched

    root = str(tmp_path / "port")
    ds = FileSystemDataStore(root, partition_size=128, device="cpu")
    ds.create_schema("t", SPEC)
    with props(sub_heartbeat_s=0.2, sched_default_deadline_ms=20_000.0):
        srv, _ = serve_background(FileSystemDataStore(root, partition_size=128, device="cpu"),
                                  stream=True, sched=tsched.SchedConfig(max_inflight=2))
        try:
            base = _url(srv)
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            rd = _SSEReader(base, sub["id"])
            _wait(lambda: rd.keepalives, msg="the stream is armed")
            codes, t0 = [], time.monotonic()

            def append(i):
                codes.append(_post(base, "/append/t", _append_doc([i], x=5.0))[0])

            threads = [threading.Thread(target=append, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            took = time.monotonic() - t0
            try:
                _wait(lambda: len(rd.matches) == 8, msg="every append's event")
            finally:
                rd.stop()
            assert codes == [200] * 8 and took < 10.0
            assert srv.pubsub.match_faults == 0 and srv.pubsub.matcher.launches == 8
            assert sorted(s for s, _ in rd.matches) == list(range(8))
        finally:
            srv.shutdown()
            srv.server_close()


def test_a_resume_during_concurrent_appends_waits_on_no_worker(tmp_path):
    """A ``Last-Event-ID`` resume replays on its handler thread under the
    hub's match lock while appends hold both scheduler workers and wait on
    that lock: the replay's match runs in line, so every append acks at
    once and the resumed stream gets every seq above its cursor exactly
    once. (The JAX package's replay submits its join to the scheduler from
    under that lock and waits for a worker that never frees, ROADMAP
    section 3.)"""
    from geomesa_tpu_torch import sched as tsched

    root = str(tmp_path / "port")
    ds = FileSystemDataStore(root, partition_size=128, device="cpu")
    ds.create_schema("t", SPEC)
    with props(sub_heartbeat_s=0.2, sched_default_deadline_ms=20_000.0):
        srv, _ = serve_background(FileSystemDataStore(root, partition_size=128, device="cpu"),
                                  stream=True, sched=tsched.SchedConfig(max_inflight=2))
        try:
            base = _url(srv)
            sub = _ok(_post(base, "/subscribe/t", {"bbox": [0, 0, 20, 20]}))
            seqs = [_ok(_post(base, "/append/t", _append_doc([i], x=5.0)))["seq"]
                    for i in range(40)]
            acks, t0 = [], time.monotonic()

            def append(k):
                for i in range(8):
                    res = _post(base, "/append/t", _append_doc([100 + 8 * k + i], x=5.0))
                    acks.append((res[0], json.loads(res[2]).get("seq") if res[0] == 200 else None))

            rd = _SSEReader(base, sub["id"], headers={"Last-Event-ID": str(seqs[1])})
            threads = [threading.Thread(target=append, args=(k,)) for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            took = time.monotonic() - t0
            want = seqs[2:] + sorted(q for _c, q in acks if q is not None)
            try:
                _wait(lambda: len(rd.matches) >= len(want), msg="every seq above the cursor")
                time.sleep(0.3)
                assert rd.error is None
            finally:
                rd.stop()
            assert [c for c, _q in acks] == [200] * 16 and took < 10.0
            assert [q for q, _f in rd.matches] == want
            assert srv.pubsub.match_faults == 0
        finally:
            srv.shutdown()
            srv.server_close()
