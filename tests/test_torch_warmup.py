"""Port parity for the resident warmup: ``DeviceIndex.warmup_plan`` and
``warmup``, ``geomesa_tpu_torch.warmup`` (plan, run, start, progress),
``make_server(warm=True)`` behind the ``/readyz`` gate, ``/stats`` and the
``geomesa_warmup_signatures`` gauge, and the CLI's ``warmup`` command,
each against the JAX package's on the same seeded rows (stores on
``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``).

The cases of the reference's ``tests/test_warmup.py`` that hold on the
card's terms are ported: the ``_system`` tenant, a failed leg counted and
not raised, the readiness gate, the CLI's progress probe and the server's
background pass. Neither side's ``compiled`` / ``from_cache`` split is
compared with the other's: the JAX package compiles on the CPU, the port
builds no kernel there. A leg that sees a kernel build (a build-listener
event) counts as ``compiled``.

One divergence is held here: the reference's fused legs call
``fused_loose_counts`` without ``loose`` and, under the default
``query.loose.bbox=false``, launch nothing; the port's pass ``loose=True``
(the scheduler fuses loose requests only; ROADMAP section 3).
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from _torch_fs_cases import rows
from _torch_server_cases import reset_singletons

from geomesa_tpu import ledger as jledger
from geomesa_tpu import warmup as jwarmup
from geomesa_tpu.conf import prop_override as jprop
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.server import serve_background as jserve
from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu.tools.cli import main as jmain
from geomesa_tpu_torch import ledger, metrics, warmup
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.kernels import _build
from geomesa_tpu_torch.server import serve_background
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.memory import MemoryDataStore
from geomesa_tpu_torch.tools.cli import main

torch.set_num_threads(2)  # xdist workers share the host's cores

SPECS = {
    "z3": "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326",
    "z2": "name:String,count:Int,*geom:Point:srid=4326",
    "xz2": "name:String,count:Int,*geom:Polygon:srid=4326",
    "xz3": "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326",
}
KINDS = ["z3", "z2", "xz2", "xz3", "empty"]
LADDERS = [(None, None), (8, 4), (64, 64), (1, 1), (100, 3)]


@pytest.fixture(autouse=True)
def _fresh():
    reset_singletons()
    yield
    reset_singletons()


def _stores(kind: str, n: int = 300, seed: int = 7, tn: str = "t"):
    """(port store, JAX store) with one type ``tn`` of ``kind`` ("empty": a
    z3 schema with no rows), the same rows and fids in each."""
    spec = SPECS["z3" if kind == "empty" else kind]
    tds, jds = MemoryDataStore(device="cpu"), JMemory()
    for ds in (tds, jds):
        ds.create_schema(tn, spec)
    if kind != "empty":
        cols = rows(kind, n, seed)
        for ds in (tds, jds):
            ds.write(tn, cols, fids=np.arange(n))
    return tds, jds


def _pair(kind: str, **kw):
    tds, jds = _stores(kind, **kw)
    return (DeviceIndex(tds, "t", z_planes=True, device="cpu"),
            JIndex(jds, "t", z_planes=True))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def _url(server) -> str:
    host, port = server.server_address[:2]
    return f"http://{host}:{port}"


def _stdout(fn, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _doc(d: dict) -> dict:
    """A progress document without the split and the wall seconds."""
    return {k: v for k, v in d.items() if k not in ("compiled", "from_cache", "seconds")}


@pytest.mark.parametrize("ladders", LADDERS, ids=lambda v: f"k{v[0]}-q{v[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_plan_signatures_equal_the_reference(kind, ladders):
    tdi, jdi = _pair(kind)
    knn_kmax, fusion_max = ladders
    got = [s for s, _ in tdi.warmup_plan(knn_kmax=knn_kmax, fusion_max=fusion_max)]
    want = [s for s, _ in jdi.warmup_plan(knn_kmax=knn_kmax, fusion_max=fusion_max)]
    assert got == want
    assert bool(got) == (kind != "empty")


def test_full_plan_equals_the_reference_under_the_conf_defaults():
    """``warmup.plan`` over two indexes: type-qualified signatures in type
    order, the ladders' bounds from ``compile.warmup.knn.kmax`` (64) and
    ``sched.max.fusion`` (64); then with both keys overridden."""
    a, ja = _pair("z3")
    b, jb = _pair("xz2", seed=8)
    got = [s for s, _ in warmup.plan({"pts": a, "boxes": b})]
    want = [s for s, _ in jwarmup.plan({"pts": ja, "boxes": jb})]
    assert got == want and "pts:knn:k=64" in got and "pts:fused_query:q=64" in got
    with prop_override("compile.warmup.knn.kmax", 20), prop_override("sched.max.fusion", 5), \
            jprop("compile.warmup.knn.kmax", 20), jprop("sched.max.fusion", 5):
        got = [s for s, _ in warmup.plan({"pts": a})]
        want = [s for s, _ in jwarmup.plan({"pts": ja})]
    assert got == want and "pts:knn:k=32" in got and "pts:fused_counts:q=8" in got


def test_the_chip_script_signatures_equal_the_reference():
    """``chip_smoke.py`` phase 3n checks its warmup pass against a constant
    signature list: it must be the reference's plan of the same three
    point indexes (a z3 type, its z2 sibling, the interleaved z3 index)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_warmup", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tds, jds = _stores("z3")
    zds, jzds = _stores("z2", seed=9, tn="points")
    idx = {tn: JIndex(jds, "t", z_planes=True) for tn in smoke.WARM_TYPES if tn != "points"}
    idx["points"] = JIndex(jzds, "points", z_planes=True)
    want = [s for s, _ in jwarmup.plan(idx, knn_kmax=64, fusion_max=64)]
    assert smoke.warm_signatures() == want
    port = {tn: DeviceIndex(tds, "t", z_planes=True, device="cpu") for tn in smoke.WARM_TYPES
            if tn != "points"}
    port["points"] = DeviceIndex(zds, "points", z_planes=True, device="cpu")
    assert [s for s, _ in warmup.plan(port, knn_kmax=64, fusion_max=64)] == want


@pytest.mark.parametrize("kind", KINDS)
def test_warmup_keys_and_nones_equal_the_reference(kind):
    tdi, jdi = _pair(kind)
    got, want = tdi.warmup(), jdi.warmup()
    assert list(got) == list(want)
    assert {k: v is None for k, v in got.items()} == {k: v is None for k, v in want.items()}
    if kind in ("z3", "z2"):
        assert None not in got.values()
    else:
        assert got["knn"] is None and got["density"] is None


def _norm(v):
    """A leg's answer in a form both packages share."""
    if v is None or isinstance(v, (int, np.integer)):
        return v
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "to_json"):
        return v.to_json()
    if hasattr(v, "fids"):
        return [str(f) for f in v.fids]
    if isinstance(v, tuple):
        return [_norm(x) for x in v]
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return np.asarray(v).tolist()


@pytest.mark.parametrize("kind", ["z3", "z2", "xz2", "xz3"])
def test_base_legs_answer_as_the_reference(kind):
    """Each base leg's answer (counts, mask, kNN rows, the window union,
    the window pairs, the density grid, the stats) equals the reference's
    leg's on the same rows: the warmup warms the very calls users make."""
    tdi, jdi = _pair(kind)
    got = dict(tdi.warmup_plan())
    want = dict(jdi.warmup_plan())
    for sig in want:
        g, w = got[sig](), want[sig]()
        if sig == "knn":
            assert _norm(g[0]) == _norm(w[0])
            np.testing.assert_allclose(g[1], w[1], rtol=1e-6)
            continue
        assert _norm(g) == _norm(w), sig


def test_fused_legs_launch_where_the_reference_launches_nothing():
    """The port's fused legs answer as the loose serial calls they fuse;
    the reference's return None under the default conf (loose off)."""
    tdi, jdi = _pair("z3")
    q = dict(tdi.warmup_plan())["count_loose_city"]()
    for sig, fn in tdi.warmup_plan(fusion_max=8):
        if sig.startswith("fused_counts:q="):
            assert fn() == [q] * int(sig.split("=")[1])
        elif sig.startswith("fused_query:q="):
            out = fn()
            assert len(out) == int(sig.split("=")[1]) and all(len(b) == q for b in out)
    for sig, fn in jdi.warmup_plan(fusion_max=8):
        if sig.startswith("fused_"):
            assert fn() is None


def test_run_charges_system_tenant_never_the_caller():
    """A request collector installed on the caller's thread sees none of
    the warmup's cost; every leg's row lands on the ``_system`` tenant, and
    the progress document closes: every leg in exactly one bucket."""
    tdi, _ = _pair("z3")
    with ledger.collect_cost(tenant="alice", endpoint="query", lane="online") as cost:
        out = warmup.run({"t": tdi}, threads=2, knn_kmax=8, fusion_max=4)
    assert cost.snapshot_fields() == {}
    snap = ledger.LEDGER.snapshot()
    assert "_system" in snap["tenants"] and "alice" not in snap["tenants"]
    assert snap["tenants"]["_system"]["requests"] == out["done"]
    assert out["state"] == "warm" and out["failed"] == 0
    assert out["done"] == out["signatures_total"] == len(warmup.plan({"t": tdi}, knn_kmax=8,
                                                                     fusion_max=4))
    assert out["compiled"] + out["from_cache"] == out["done"]
    assert metrics.warmup_signatures.value(state="total") == out["done"]
    assert metrics.warmup_signatures.value(state="failed") == 0
    text = metrics.REGISTRY.prometheus_text()
    assert f'geomesa_warmup_signatures{{state="total"}} {out["done"]}' in text


def test_run_documents_equal_the_reference():
    tdi, jdi = _pair("z3")
    got = warmup.run({"t": tdi}, threads=2, knn_kmax=16, fusion_max=8)
    want = jwarmup.run({"t": jdi}, threads=2, knn_kmax=16, fusion_max=8)
    assert _doc(got) == _doc(want)
    assert got["compiled"] == 0 and got["from_cache"] == got["done"]  # no nvcc on the CPU


class _Legs:
    """A fake index whose plan is the given legs."""

    def __init__(self, legs):
        self.legs = legs

    def warmup_plan(self, knn_kmax=None, fusion_max=None):
        return list(self.legs)


def test_failed_leg_is_counted_not_raised():
    def die():
        raise RuntimeError("kernel exploded")

    legs = [("boom", die), ("ok", lambda: 1)]
    got = warmup.run({"t": _Legs(legs)}, threads=1)
    want = jwarmup.run({"t": _Legs(legs)}, threads=1)
    assert got == {"state": "warm", "signatures_total": 2, "done": 2, "compiled": 0,
                   "from_cache": 1, "failed": 1, "seconds": got["seconds"]}
    assert _doc(got) == _doc(want) and want["failed"] == 1
    snap = ledger.LEDGER.snapshot()
    assert snap["tenants"]["_system"]["errors"] == 1


class _Unplannable:
    """A fake index whose plan raises, as reading its planes on the card can
    (a CUDA error, an OOM)."""

    def warmup_plan(self, knn_kmax=None, fusion_max=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_an_index_that_fails_to_plan_counts_as_a_failed_leg(monkeypatch):
    """The other indexes still warm, the pass ends ``warm`` and the
    planning row on ``_system`` is an error. The reference plans before its
    ``try`` and raises with the state left at ``warming`` (ROADMAP section
    3), which the second half shows."""
    with pytest.warns(UserWarning, match="warmup plan of 'a' failed"):
        got = warmup.run({"a": _Unplannable(), "b": _Legs([("ok", lambda: 1)])}, threads=1)
    assert got == {"state": "warm", "signatures_total": 2, "done": 2, "compiled": 0,
                   "from_cache": 1, "failed": 1, "seconds": got["seconds"]}
    assert not warmup.warming()
    assert metrics.warmup_signatures.value(state="failed") == 1
    assert ledger.LEDGER.snapshot()["tenants"]["_system"]["errors"] == 1
    with pytest.raises(RuntimeError, match="illegal memory access"):
        jwarmup.run({"a": _Unplannable()}, threads=1)
    died = []
    monkeypatch.setattr(threading, "excepthook", lambda args: died.append(args.exc_value))
    t = jwarmup.start({"a": _Unplannable()}, threads=1)
    t.join(timeout=30)
    assert len(died) == 1  # the reference's warmup thread died in its plan
    assert jwarmup.warming()  # the reference's server would answer 503 for good
    with pytest.warns(UserWarning, match="warmup plan of 'a' failed"):
        t = warmup.start({"a": _Unplannable()}, threads=1)
        t.join(timeout=30)
    assert not warmup.warming() and len(died) == 1  # the port's thread ended its pass


def test_a_server_whose_plan_raises_still_becomes_ready(monkeypatch):
    """``make_server(warm=True)`` under gate ``ready``: a plan that raises
    on the warmup thread is one failed leg, and ``/readyz`` reaches 200."""
    tds, _ = _stores("z3", n=60, tn="gdelt")

    def die(self, *a, **kw):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(DeviceIndex, "warmup_plan", die)
    with prop_override("compile.warmup.gate", "ready"), pytest.warns(UserWarning,
                                                                       match="warmup plan"):
        ps, _ = serve_background(tds, resident=True, warm=True)
        try:
            _wait_ready(_url(ps))
            w = _get(f"{_url(ps)}/stats")[1]["warmup"]
        finally:
            ps.shutdown()
            ps.server_close()
    assert (w["state"], w["signatures_total"], w["done"], w["failed"]) == ("warm", 1, 1, 1)


def test_a_leg_that_sees_a_kernel_build_counts_as_compiled():
    """A build-listener event inside a leg (an ``nvcc`` run) charges the
    leg's ``_system`` row a compile, and the leg counts as ``compiled``; a
    library found built counts as ``from_cache``."""
    events = dict(_build._events)
    try:
        legs = [("build", lambda: _build._note_build("filter_scan", True, 0.25)),
                ("load", lambda: _build._note_build("density", False, 0.0)),
                ("plain", lambda: None)]
        out = warmup.run({"t": _Legs(legs)}, threads=1)
    finally:
        _build._events.update(events)
    assert (out["compiled"], out["from_cache"], out["failed"]) == (1, 2, 0)
    assert metrics.warmup_signatures.value(state="compiled") == 1
    snap = ledger.LEDGER.snapshot()
    assert snap["tenants"]["_system"]["cost"]["compiles"] == 1
    assert ledger.COMPILES.snapshot()["compiles"] == 1


class _Blocked:
    """A fake index whose one leg parks until released: the warming window
    is deterministic for the readiness gate."""

    def __init__(self):
        self.release = threading.Event()

    def warmup_plan(self, knn_kmax=None, fusion_max=None):
        return [("block", lambda: self.release.wait(30))]


@pytest.fixture()
def gated():
    """Both packages' servers (not resident) with a blocked warmup pass
    marked as started on each handler, as ``make_server(warm=True)`` does."""
    tds, jds = _stores("z3", n=50)
    ps, _ = serve_background(tds)
    js, _ = jserve(jds)
    fakes, threads = [], []
    for server, mod in ((ps, warmup), (js, jwarmup)):
        server.RequestHandlerClass._warmup_started = True
        fake = _Blocked()
        fakes.append(fake)
        threads.append(mod.start({"t": fake}))
    try:
        yield _url(ps), _url(js), fakes, threads
    finally:
        for f in fakes:
            f.release.set()
        for t in threads:
            t.join(timeout=30)
        for s in (ps, js):
            s.shutdown()
            s.server_close()


def test_readyz_gates_until_warm(gated):
    purl, jurl, fakes, threads = gated
    assert warmup.warming() and jwarmup.warming()  # start() stamps before it returns
    for gate in ("ready", "stamp", "off"):
        with prop_override("compile.warmup.gate", gate), jprop("compile.warmup.gate", gate):
            (ps, pd), (js, jd) = _get(f"{purl}/readyz"), _get(f"{jurl}/readyz")
        assert ps == js == (503 if gate == "ready" else 200), gate
        assert (pd["ready"], pd.get("warming")) == (jd["ready"], jd.get("warming")), gate
        assert ("warming" in pd) == (gate != "off")
    st, doc = _get(f"{purl}/stats")
    assert st == 200 and doc["warmup"] == _get(f"{jurl}/stats")[1]["warmup"]
    assert doc["warmup"]["state"] == "warming" and "compile_cache" in doc
    for f, t in zip(fakes, threads):
        f.release.set()
        t.join(timeout=30)
        assert not t.is_alive()
    for url in (purl, jurl):
        status, doc = _get(f"{url}/readyz")
        assert status == 200 and doc["ready"] and "warming" not in doc
        status, doc = _get(f"{url}/stats")
        assert doc["warmup"]["state"] == "warm" and doc["warmup"]["done"] == 1


def test_a_bad_gate_raises_as_the_reference():
    with pytest.raises(ValueError, match="compile.warmup.gate must be ready, stamp or off"):
        prop_override("compile.warmup.gate", "sometimes").__enter__()
    with pytest.raises(ValueError, match="compile.warmup.gate must be ready, stamp or off"):
        jprop("compile.warmup.gate", "sometimes").__enter__()


def test_warmup_cli_reports_remote_progress(gated):
    """``warmup --url`` is the operator's progress probe: the same lines as
    the reference's but the compile-cache line, which reports the kernel
    build cache where the reference reports its XLA cache."""
    purl, jurl, fakes, threads = gated

    def lines(fn, url):
        return [ln for ln in _stdout(fn, ["warmup", "--url", url]).splitlines()
                if not ln.startswith("persistent cache:")]

    got = lines(main, purl)
    assert got == lines(jmain, jurl) == ["state: warming",
                                         "signatures: 0/1 (compiled 0, from cache 0, failed 0)"]
    for f, t in zip(fakes, threads):
        f.release.set()
        t.join(timeout=30)
    got = _stdout(main, ["warmup", "--url", purl])
    assert got.splitlines()[0] == "state: warm" and "signatures: 1/1" in got
    assert "persistent cache: enabled=True" in got
    assert [ln for ln in got.splitlines() if not ln.startswith(("wall:", "persistent"))] == \
        [ln for ln in _stdout(jmain, ["warmup", "--url", jurl]).splitlines()
         if not ln.startswith(("wall:", "persistent"))]


def _wait_ready(url: str) -> dict:
    for _ in range(600):
        status, doc = _get(f"{url}/readyz")
        if status == 200:
            return doc
        assert doc["warming"] and not doc["ready"]
        time.sleep(0.05)
    raise AssertionError("the warmup never ended")


def test_server_warm_runs_background_warmup():
    """``make_server(warm=True)``: the resident cache is full when the
    server is returned, the full plan runs in the background under the
    ``_system`` tenant, and ``/stats`` reports it as the reference's."""
    tds, jds = _stores("z3", n=60, tn="gdelt")
    ps, _ = serve_background(tds, resident=True, warm=True)
    try:
        assert "gdelt" in ps.RequestHandlerClass._resident_cache
        doc = _wait_ready(_url(ps))
        assert "warming" not in doc
        pw = _get(f"{_url(ps)}/stats")[1]["warmup"]
    finally:
        ps.shutdown()
        ps.server_close()
    warmup.reset()
    js, _ = jserve(jds, resident=True, warm=True)
    try:
        _wait_ready(_url(js))
        jw = _get(f"{_url(js)}/stats")[1]["warmup"]
    finally:
        js.shutdown()
        js.server_close()
    assert _doc(pw) == _doc(jw)
    assert pw["state"] == "warm" and pw["failed"] == 0 and pw["signatures_total"] == 31
    assert ledger.LEDGER.snapshot()["tenants"]["_system"]["requests"] >= pw["done"]


def test_server_warm_inline_when_the_background_pass_is_off():
    """``compile.warmup.enabled=false``: each index's base legs run inline
    before the server is returned; no background pass, ``/readyz`` open."""
    tds, _ = _stores("z3", n=60, tn="gdelt")
    calls = []
    real = DeviceIndex.warmup

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        calls.append(out)
        return out

    DeviceIndex.warmup = spy
    try:
        with prop_override("compile.warmup.enabled", False):
            ps, _ = serve_background(tds, resident=True, warm=True)
    finally:
        DeviceIndex.warmup = real
    try:
        assert len(calls) == 1 and None not in calls[0].values()
        status, doc = _get(f"{_url(ps)}/readyz")
        assert status == 200 and "warming" not in doc
        assert _get(f"{_url(ps)}/stats")[1]["warmup"]["state"] == "idle"
    finally:
        ps.shutdown()
        ps.server_close()


def test_a_type_that_fails_to_stage_is_warned_and_skipped(monkeypatch):
    from geomesa_tpu_torch import server as srv

    tds, _ = _stores("z3", n=60, tn="gdelt")
    tds.create_schema("other", SPECS["z2"])
    real = srv._make_resident_index

    def make(store, type_name, streaming=False):
        if type_name == "other":
            raise RuntimeError("out of device memory")
        return real(store, type_name, streaming=streaming)

    monkeypatch.setattr(srv, "_make_resident_index", make)
    with pytest.warns(UserWarning, match="warm staging failed for 'other'"):
        ps, _ = serve_background(tds, resident=True, warm=True)
    try:
        assert set(ps.RequestHandlerClass._resident_cache) == {"gdelt"}
        _wait_ready(_url(ps))
    finally:
        ps.shutdown()
        ps.server_close()


def test_warmup_cli_local_mode_equals_the_reference(tmp_path):
    """``warmup`` without ``--url`` stages the root's types and runs the
    full plan: the printed document equals the reference's but the split
    and the seconds; ``-f`` warms one type; an empty root exits."""
    proot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    for ds in (FileSystemDataStore(proot, device="cpu"), JFS(jroot)):
        ds.create_schema("a", SPECS["z3"])
        ds.create_schema("b", SPECS["xz2"])
        ds.write("a", rows("z3", 200, 3), fids=np.arange(200))
        ds.write("b", rows("xz2", 100, 4), fids=np.arange(100))
        ds.flush("a")
        ds.flush("b")
    with jprop("compile.cache.dir", str(tmp_path / "xla")):
        for argv in ([], ["-f", "b"]):
            got = json.loads(_stdout(main, ["--root", proot, "--device", "cpu", "warmup", *argv]))
            want = json.loads(_stdout(jmain, ["--root", jroot, "warmup", *argv]))
            assert _doc(got) == _doc(want) and got["failed"] == 0
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no schemas"):
        main(["--root", empty, "--device", "cpu", "warmup"])
