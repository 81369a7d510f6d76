"""The port's command line, ``python -m geomesa_tpu_torch.tools``, in child
processes on the CPU (``--device cpu``): ``load-driver`` self-serves a
small file-system root and reports throughput, latency, shed load and the
scheduler's counters; ``serve`` prints its address, answers, and drains
on POST ``/admin/shutdown``; ``serve --resident --warm`` holds ``/readyz``
until its warmup pass ends.
Every child is port code only and is given a timeout."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
from _torch_fs_cases import rows

from geomesa_tpu_torch.store.fs import FileSystemDataStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
BOX = "BBOX(geom, -40.5, -20.25, 60.75, 45.5)"


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("GEOMESA_TPU_")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.fixture
def fs_root(tmp_path):
    ds = FileSystemDataStore(str(tmp_path / "root"), partition_size=128, device="cpu")
    ds.create_schema("t", SPEC)
    ds.write("t", rows("z3", 900, 41))
    ds.flush("t")
    return ds


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.tools", *args], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=timeout)


def _report(stdout: str) -> dict:
    """The JSON report: the lines up to the first closing brace at column 0."""
    lines = stdout.splitlines()
    end = lines.index("}")
    return json.loads("\n".join(lines[: end + 1]))


@pytest.mark.parametrize("endpoint,loose", [("count", True), ("count", False), ("features", False)])
def test_load_driver_self_served_reports(fs_root, endpoint, loose):
    args = ["--root", fs_root.root, "--device", "cpu", "load-driver", "-f", "t", "-q", BOX,
            "--endpoint", endpoint, "--threads", "3", "--requests", "4", "--tenants", "2"]
    out = _cli(*args + (["--loose"] if loose else []))
    assert out.returncode == 0, out.stderr[-2000:]
    rep = _report(out.stdout)
    assert rep["requests"] == 12 and rep["ok"] + rep["rejected_429"] + rep["errors"] == 12
    assert rep["errors"] == 0 and rep["ok"] > 0
    assert rep["p50_ms"] > 0 and rep["p99_ms"] >= rep["p50_ms"] and rep["qps"] > 0
    assert rep["sched"]["queries"] >= rep["ok"]
    assert "per-tenant cost + latency" in out.stdout and "lt0" in out.stdout


def test_serve_answers_and_drains_on_admin_shutdown(fs_root):
    proc = subprocess.Popen(
        [sys.executable, "-m", "geomesa_tpu_torch.tools", "--root", fs_root.root, "--device",
         "cpu", "serve", "--port", "0", "--resident", "--sched", "--stream"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving ") and "(streaming live layer)" in line, \
            line + proc.stderr.read()[-2000:] if not line else line
        base = line.split(" on ")[1].split()[0]
        q = urllib.request.quote(BOX)
        with urllib.request.urlopen(f"{base}/count/t?cql={q}", timeout=30) as r:
            assert json.loads(r.read())["count"] == fs_root.count("t", BOX)
        req = urllib.request.Request(f"{base}/admin/shutdown", data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"draining": True}
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_warm_is_refused(fs_root):
    """``serve --warm`` was refused while the warmup was not in the port
    (the name is kept so reports of runs line up); now ``serve --resident
    --warm`` stages the type, answers ``/readyz``
    503 or 200 (never a ready server before the pass ends), and reports a
    finished pass with no failed leg on ``/stats``."""
    import time
    import urllib.error

    proc = subprocess.Popen(
        [sys.executable, "-m", "geomesa_tpu_torch.tools", "--root", fs_root.root, "--device",
         "cpu", "serve", "--port", "0", "--resident", "--warm"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), line + proc.stderr.read()[-2000:] if not line else line
        base = line.split(" on ")[1].split()[0]
        for _ in range(600):
            try:
                with urllib.request.urlopen(f"{base}/readyz", timeout=30) as r:
                    ready = json.loads(r.read())
                break
            except urllib.error.HTTPError as e:
                assert e.code == 503 and json.loads(e.read())["warming"]
                time.sleep(0.05)
        assert ready["ready"] and "warming" not in ready
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            w = json.loads(r.read())["warmup"]
        assert w["state"] == "warm" and w["failed"] == 0 and w["done"] == w["signatures_total"] > 0
        req = urllib.request.Request(f"{base}/admin/shutdown", data=b"{}", method="POST")
        urllib.request.urlopen(req, timeout=30).close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
