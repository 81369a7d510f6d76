"""The port's profiling registry and its device-trace hook
(``geomesa_tpu_torch/profiling.py``) against the JAX package's
(``geomesa_tpu/profiling.py``), on the CPU.

- ``profile`` / ``profiled`` / ``timings`` / ``reset`` / ``report``: the
  same labels, counts and table in both packages.
- The query path is instrumented as the reference's: a memory-store query
  counts ``query.scan`` (the runner) and ``plan.scan_ranges`` (the range
  decomposition) in both packages.
- ``device_trace`` writes one Chrome trace a block (CPU activities here);
  the runner's ``trace.device.dir`` hook writes one only for a sampled
  trace and only when the key names a directory, named by the trace id.
"""

import json
import os
import re
import threading

import numpy as np
import pytest

from geomesa_tpu import profiling as jprofiling
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch import profiling
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.store.memory import MemoryDataStore
from geomesa_tpu_torch.tracing import TRACER

ROW = re.compile(r"^(\S+)\s+(\d+)\s")


@pytest.fixture(autouse=True)
def _reset():
    for mod in (profiling, jprofiling):
        mod.reset()
    yield
    for mod in (profiling, jprofiling):
        mod.reset()


def _counts(mod) -> dict:
    return {k: v["count"] for k, v in mod.timings().items()}


def test_profile_registry_as_the_reference():
    for mod in (profiling, jprofiling):
        assert mod.report() == "(no profile data)"
        with mod.profile("unit.block"):
            pass
        with pytest.raises(RuntimeError):
            with mod.profile("unit.raises"):
                raise RuntimeError("still timed")

        @mod.profiled("unit.fn")
        def f(x):
            return x + 1

        @mod.profiled()
        def g():
            return 7

        assert f(1) == 2 and f(2) == 3 and g() == 7
    assert _counts(profiling) == _counts(jprofiling)
    want = {"unit.block": 1, "unit.raises": 1, "unit.fn": 2,
            "test_profile_registry_as_the_reference.<locals>.g": 1}
    assert _counts(profiling) == want
    for label, t in profiling.timings().items():
        assert set(t) == {"count", "total_ms", "mean_ms", "max_ms"}
        assert t["max_ms"] <= t["total_ms"] + 1e-9 and t["mean_ms"] <= t["max_ms"] + 1e-9
    a, b = profiling.report().splitlines(), jprofiling.report().splitlines()
    assert a[0] == b[0] and len(a) == len(b) == 5
    assert sorted(ROW.match(r).groups() for r in a[1:]) == sorted(ROW.match(r).groups() for r in b[1:])
    for mod in (profiling, jprofiling):
        mod.reset()
        assert mod.timings() == {}


def test_profile_is_thread_safe():
    def work():
        for _ in range(200):
            with profiling.profile("threads"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert profiling.timings()["threads"]["count"] == 1600


def _stores():
    tds, jds = MemoryDataStore(device="cpu"), JMemory()
    for ds in (tds, jds):
        ds.create_schema("t", "dtg:Date,*geom:Point")
        ds.write("t", {"dtg": np.arange(100) * 1000, "geom": np.zeros((100, 2))},
                 fids=np.arange(100))
    return tds, jds


@pytest.mark.parametrize("cql", ["BBOX(geom, -1, -1, 1, 1)",
                                 "BBOX(geom, -1, -1, 1, 1) AND dtg DURING "
                                 "1970-01-01T00:00:00Z/1970-01-01T00:00:50Z",
                                 "INCLUDE"])
def test_the_query_path_is_instrumented_as_the_reference(cql):
    tds, jds = _stores()
    assert len(tds.query("t", cql)) == len(jds.query("t", cql))
    got, want = _counts(profiling), _counts(jprofiling)
    assert got == want
    assert got.get("query.scan", 0) >= 1
    assert ("plan.scan_ranges" in got) == (cql != "INCLUDE")


def _trace_files(d) -> list:
    return sorted(n for n in os.listdir(d) if n.endswith(".pt.trace.json"))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    d = str(tmp_path / "traces")
    with profiling.device_trace(d, name="unit") as path:
        torch.ones(64).cumsum(0)
    assert path is not None and os.path.basename(path) in _trace_files(d)
    assert re.fullmatch(r"unit-\d+\.pt\.trace\.json", os.path.basename(path))
    doc = json.load(open(path))
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    with profiling.device_trace(d) as p2:
        with profiling.device_trace(d) as inner:  # one session at a time
            assert inner is None
    assert os.path.basename(p2).startswith("trace-") and len(_trace_files(d)) == 2


@pytest.mark.parametrize("sample,key,written", [(1.0, True, True), (0.0, True, False),
                                                (1.0, False, False)],
                         ids=["sampled", "unsampled", "no-dir"])
def test_the_runner_hook_traces_only_sampled_requests(tmp_path, sample, key, written):
    """``trace.device.dir`` wraps a store run's launch in ``device_trace``
    only for a sampled trace and only when the key names a directory."""
    tds, _ = _stores()
    d = str(tmp_path / "dev")
    tds.query("t", "BBOX(geom, -1, -1, 1, 1)")  # the index builds outside the trace
    with prop_override("trace.device.dir", d if key else ""), prop_override("trace.sample", sample), \
            prop_override("trace.slow_ms", 0.0):
        with TRACER.trace("unit") as tr:
            assert tr.sampled == (sample > 0)
            assert len(tds.query("t", "BBOX(geom, -1, -1, 1, 1)")) == 100
        tds.query("t", "BBOX(geom, -1, -1, 1, 1)")  # no trace at all: untraced
    files = _trace_files(d) if os.path.isdir(d) else []
    if written:
        assert files and all(f.startswith(tr.trace_id + "-") for f in files)
        doc = json.load(open(os.path.join(d, files[0])))
        names = {e.get("name") for e in doc["traceEvents"]}
        assert doc["traceEvents"] and names
    else:
        assert files == []
