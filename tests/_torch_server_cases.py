"""Shared harness of the server parity tests (``tests/test_torch_server*.py``):
the port's HTTP server (``geomesa_tpu_torch.server``, stores on
``device="cpu"``) beside the JAX package's (``geomesa_tpu.server``), each
over its own store fed the same seeded rows, a stdlib client with a 30 s
timeout, and the process singletons of both packages reset between tests.

Rows are float32-exact (``_torch_fs_cases.rows``), so the JAX package's
CPU staging in float64 and the port's float32 planes answer alike
(ROADMAP section 3, Definitions).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
from _torch_fs_cases import DAY, T0, rows

from geomesa_tpu import ledger as jledger
from geomesa_tpu import resilience as jres
from geomesa_tpu import slo as jslo
from geomesa_tpu import tracing as jtracing
from geomesa_tpu import warmup as jwarmup
from geomesa_tpu.server import serve_background as jserve
from geomesa_tpu.store.memory import MemoryDataStore as JMemory
from geomesa_tpu_torch import ledger, resilience, slo, tracing, warmup
from geomesa_tpu_torch.server import serve_background
from geomesa_tpu_torch.store.memory import MemoryDataStore

Z3 = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
Z2 = "name:String,count:Int,*geom:Point:srid=4326"
TIMEOUT = 30

BOX = "BBOX(geom, -40.5, -20.25, 60.75, 45.5)"
DURING = "dtg DURING 2020-01-02T00:00:00Z/2020-01-04T12:00:00Z"
Q1 = f"{BOX} AND {DURING}"


def reset_singletons(flightrec_dir=None) -> None:
    """Both packages' process-wide serving state back to a fresh process:
    the cost and compile ledgers, the SLO engine, the flight recorder
    (pointed at ``flightrec_dir``), the trace ring and slow log, the
    breakers, the warmup's progress document."""
    for w in (warmup, jwarmup):
        w.reset()
    for led, s, tr, res in ((ledger, slo, tracing, resilience), (jledger, jslo, jtracing, jres)):
        led.LEDGER.reset()
        led.COMPILES.reset()
        s.ENGINE.reset()
        s.FLIGHTREC.reset()
        if flightrec_dir is not None:
            s.FLIGHTREC.configure(str(flightrec_dir))
        tr.TRACER.clear()
        tr.TRACER.slow_log_path = None
        res.reset()


def memory_pair(n: int = 3000, seed: int = 5):
    """(port store, JAX store): a z3 type ``gdelt`` with a labeled share
    and a z2 sibling ``gdelt2``, the same rows in each."""
    tds = MemoryDataStore(device="cpu")
    jds = JMemory()
    z3 = rows("z3", n, seed, labels=True)
    z2 = rows("z2", n // 2, seed + 1)
    for ds in (tds, jds):
        ds.create_schema("gdelt", Z3)
        ds.create_schema("gdelt2", Z2)
        ds.write("gdelt", z3, fids=np.arange(n))
        ds.write("gdelt2", z2, fids=np.arange(n // 2))
    return tds, jds


@contextmanager
def serving(tds, jds, **kw):
    """Both servers on ephemeral loopback ports; shut down on exit."""
    ps, _ = serve_background(tds, **kw)
    try:
        js, _ = jserve(jds, **kw)
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


def _url(server) -> str:
    host, port = server.server_address[:2]
    return f"http://{host}:{port}"


def fetch(base: str, path: str, headers=None, method: str = "GET", body=None):
    """(status, headers, body bytes) of one request; HTTP errors answer
    like successes."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers, e.read()


def q(s: str) -> str:
    return urllib.request.quote(s)


def iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def track_param() -> str:
    return ";".join(f"{x},{y},{T0 + k * DAY // 2}" for k, (x, y) in
                    enumerate([(-40.0, -10.0), (0.0, 5.0), (30.0, 20.0)]))
