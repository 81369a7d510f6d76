"""Port parity for the HTTP serving bridge: ``geomesa_tpu_torch.server``
against ``geomesa_tpu.server`` over memory stores fed the same seeded rows
(a z3 type with a labeled share and a z2 sibling), resident and not, with
the device query scheduler on and off.

Every GET endpoint in the port's scope answers with the same status, the
same content type, the same ``X-Request-Id`` echo and ``X-Degraded``
reasons, and the same document: GeoJSON collections in order (the process
endpoints' float distances within 1e-6 relative), counts, density grids,
stats JSON, ``/explain`` text, BIN bytes, error bodies. What the port does
not serve answers as ROADMAP names it: Arrow 406, the push tier and
replication 501, ``/stats/replica`` and ``/stats/pubsub``
``{"enabled": false}``, ``warm=True`` and ``replica=`` raise.
"""

import json

import numpy as np
import pytest
from _torch_server_cases import (
    BOX, DURING, Q1, fetch, memory_pair, q, reset_singletons, serving, track_param,
)

MODES = [(False, False), (False, True), (True, False), (True, True)]
MODE_IDS = ["store", "store-sched", "resident", "resident-sched"]

PATHS = [
    "/capabilities",
    f"/count/gdelt?cql={q(Q1)}",
    f"/count/gdelt?cql={q(Q1)}&loose=1",
    f"/count/gdelt?cql={q(BOX)}&auths=A,B",
    f"/count/gdelt?cql={q(BOX)}&maxFeatures=7",
    "/count/gdelt",
    f"/count/gdelt2?cql={q('BBOX(geom, -100.25, -30.5, 20.75, 60)')}",
    f"/count/gdelt2?cql={q('BBOX(geom, -100.25, -30.5, 20.75, 60)')}&loose=1",
    f"/features/gdelt?cql={q(Q1)}&maxFeatures=25",
    f"/features/gdelt?cql={q(BOX)}&auths=A&maxFeatures=15",
    f"/features/gdelt?cql={q(BOX)}&properties=name,dtg,geom&maxFeatures=10",
    f"/features/gdelt2?cql={q('count < 50')}",
    f"/features/gdelt?cql={q(Q1)}&f=bin&track=name",
    f"/features/gdelt?cql={q(Q1)}&f=bin&track=name&sortBin=1",
    f"/explain/gdelt?cql={q(Q1)}",
    f"/density/gdelt?cql={q(DURING)}&bbox=-180,-90,180,90&width=32&height=16",
    f"/density/gdelt2?bbox=-60,-30,60,30&width=12&height=6",
    f"/stats/gdelt?cql={q(Q1)}&stats=Count()",
    f"/stats/gdelt?cql={q(BOX)}&stats={q('MinMax(count)')}",
    f"/knn/gdelt?x=10.5&y=20.25&k=6&cql={q(DURING)}",
    f"/tube/gdelt?track={track_param()}&buffer=2.5&maxDt={3 * 86_400_000}",
    f"/proximity/gdelt2?points=-40,-10;30,20&distance=3",
    "/features/nope",
    f"/count/gdelt?cql={q('BBOX(geom, 1, 2')}",
    "/bogus",
    "/density/gdelt",
    "/stats/gdelt",
    "/features/gdelt?f=bin",
    "/features/gdelt?f=xml",
    "/knn/gdelt?x=1&y=2&k=3&f=bin",
    "/healthz",
    "/stats/replica",
    "/stats/pubsub",
]

#: process outputs computed in floating point: compared within 1e-6
_FLOAT_PROPS = ("knn_distance_deg", "proximity_distance_deg")


@pytest.fixture(scope="module", params=MODES, ids=MODE_IDS)
def servers(request, tmp_path_factory):
    resident, sched = request.param
    reset_singletons(tmp_path_factory.mktemp("flightrec"))
    tds, jds = memory_pair()
    with serving(tds, jds, resident=resident, sched=sched) as (purl, jurl, ps, js):
        yield purl, jurl, resident
    reset_singletons()


def _same_features(got: dict, want: dict):
    assert got["type"] == want["type"] == "FeatureCollection"
    assert [f["id"] for f in got["features"]] == [f["id"] for f in want["features"]]
    for a, b in zip(got["features"], want["features"]):
        assert a["geometry"] == b["geometry"]
        pa, pb = dict(a["properties"]), dict(b["properties"])
        for k in _FLOAT_PROPS:
            if k in pb:
                np.testing.assert_allclose(pa.pop(k), pb.pop(k), rtol=1e-6)
        assert pa == pb


def same_response(purl, jurl, path, headers=None):
    """Status, content type, request-id echo, degradation reasons and the
    body of one GET, port against reference; returns the port's answer."""
    got = fetch(purl, path, headers)
    want = fetch(jurl, path, headers)
    assert got[0] == want[0], (path, got[2][:300], want[2][:300])
    for h in ("Content-Type", "X-Degraded") + (("X-Request-Id",) if headers else ()):
        assert got[1].get(h) == want[1].get(h), h
    assert (got[1].get("Retry-After") is None) == (want[1].get("Retry-After") is None)
    ctype = want[1].get("Content-Type") or ""
    if "json" in ctype:
        a, b = json.loads(got[2]), json.loads(want[2])
        if isinstance(b, dict) and b.get("type") == "FeatureCollection":
            _same_features(a, b)
        else:
            assert a == b
    else:
        assert got[2] == want[2]
    return got


@pytest.mark.parametrize("path", PATHS, ids=[p[:60] for p in PATHS])
def test_endpoint_answers_as_the_reference(servers, path):
    purl, jurl, _ = servers
    same_response(purl, jurl, path, {"X-Request-Id": "req-1.a:b"})


def test_request_id_is_sanitized_and_echoed_on_errors(servers):
    purl, jurl, _ = servers
    for path in ("/count/gdelt", "/features/nope", "/bogus", "/healthz"):
        got = same_response(purl, jurl, path, {"X-Request-Id": "a b/<c>\"d"})
        assert got[1]["X-Request-Id"] == "abcd"
    got = fetch(purl, "/count/gdelt")
    assert len(got[1]["X-Request-Id"]) == 16  # generated when absent


def test_arrow_answers_406_and_nothing_under_arrow_content_type(servers):
    purl, _, _ = servers
    for path, hdr in ((f"/features/gdelt?cql={q(BOX)}&f=arrow", None),
                      ("/features/gdelt", {"Accept": "application/vnd.apache.arrow.stream"}),
                      ("/knn/gdelt?x=1&y=2&k=3&f=arrow", None)):
        status, headers, body = fetch(purl, path, hdr)
        assert status == 406
        assert headers["Content-Type"] == "application/json"
        assert "ROADMAP.md section 3" in json.loads(body)["error"]


def test_the_push_tier_and_replication_answer_501(servers):
    """The push tier answers as the reference's does (a memory store has no
    live layer, so no push tier: 400 in both, ``tests/test_torch_pubsub_http.py``
    drives it over the live layer); replication's ship endpoints answer
    501, naming the replication item."""
    purl, jurl, _ = servers
    for method, path in (("GET", "/subscribe/gdelt?id=x"), ("POST", "/subscribe/gdelt"),
                         ("DELETE", "/subscribe/gdelt?id=x")):
        body = {} if method == "POST" else None
        a, b = fetch(purl, path, method=method, body=body), fetch(jurl, path, method=method, body=body)
        assert a[0] == b[0] == 400, path
        assert json.loads(a[2]) == json.loads(b[2])
        assert "push tier" in json.loads(a[2])["error"]
    for method, path in (("GET", "/wal/gdelt"), ("GET", "/snapshot/gdelt")):
        status, _, body = fetch(purl, path, method=method)
        assert status == 501, path
        err = json.loads(body)["error"]
        assert "ROADMAP item" in err and "replication" in err


def test_refresh_answers_as_the_reference(servers):
    purl, jurl, resident = servers
    got = same_response(purl, jurl, "/refresh/gdelt", {"X-Request-Id": "r"})
    if resident:
        assert json.loads(got[2]) == {"refreshed": "gdelt", "rows": 3000}


def test_monitoring_documents_match_the_reference(servers):
    """``/readyz``, ``/stats/mesh``, ``/stats/sched`` and ``/stats`` carry
    the reference's keys; the breakers and the mesh document (without the
    device count: the reference's test setup forces 8 CPU devices, the
    port counts cards) are equal."""
    purl, jurl, _ = servers
    for path in ("/readyz", "/stats/mesh", "/stats"):
        a, b = fetch(purl, path), fetch(jurl, path)
        assert a[0] == b[0] == 200
        da, db = json.loads(a[2]), json.loads(b[2])
        assert set(da) == set(db), path
        if path == "/readyz":
            assert da["breakers"] == db["breakers"]
            assert (da["ready"], da["draining"], da["degraded_domains"]) == \
                (db["ready"], db["draining"], db["degraded_domains"])
        if path == "/stats/mesh":
            da.pop("devices_visible"), db.pop("devices_visible")
            assert da == db
        if path == "/stats":
            assert da["warmup"] == {"state": "idle", "signatures_total": 0, "done": 0,
                                    "compiled": 0, "from_cache": 0, "failed": 0,
                                    "seconds": 0.0}
            assert set(da["compile_cache"]) >= {"dir", "enabled", "requests", "hits", "misses"}
    a, b = fetch(purl, "/stats/sched"), fetch(jurl, "/stats/sched")
    assert a[0] == b[0]
    if a[0] == 200:
        assert set(json.loads(a[2])) >= set(json.loads(b[2]))  # + fusion_fallbacks


def test_metrics_and_traces(servers):
    purl, _, _ = servers
    rid = "trace-me-1"
    assert fetch(purl, f"/count/gdelt?cql={q(BOX)}", {"X-Request-Id": rid})[0] == 200
    status, headers, body = fetch(purl, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = body.decode()
    assert "geomesa_slo_requests_total" in text and " # {" not in text
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
    status, headers, body = fetch(purl, "/metrics", {"Accept": "application/openmetrics-text"})
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    assert body.decode().rstrip().endswith("# EOF")
    recent = json.loads(fetch(purl, "/debug/traces?limit=50")[2])["traces"]
    assert rid in [t["trace_id"] for t in recent]
    doc = json.loads(fetch(purl, f"/debug/traces/{rid}")[2])
    assert doc["trace_id"] == rid and doc["spans"]["name"] == "GET /count/gdelt"
    perf = json.loads(fetch(purl, f"/debug/traces/{rid}?format=perfetto")[2])
    assert perf["otherData"]["trace_id"] == rid
    assert any(e["ph"] == "X" and e["name"] == "GET /count/gdelt" for e in perf["traceEvents"])
    assert fetch(purl, "/debug/traces/nope")[0] == 404


def test_ledger_and_slo_documents_count_the_same_requests(tmp_path):
    """After the same request sequence on fresh singletons, ``/stats/ledger``
    has the reference's tenants, shapes and request counts, and
    ``/stats/slo`` its series and request counts."""
    reset_singletons(tmp_path)
    tds, jds = memory_pair(n=800, seed=9)
    seq = [f"/count/gdelt?cql={q(BOX)}&tenant=t1", f"/count/gdelt?cql={q(Q1)}&tenant=t2",
           "/features/gdelt?maxFeatures=3&tenant=t1", "/features/nope?tenant=t2",
           f"/density/gdelt?bbox=-10,-10,10,10&width=4&height=4&tenant=t1&lane=batch"]
    docs = []
    with serving(tds, jds, resident=True, sched=True) as (purl, jurl, _, _):
        for base in (purl, jurl):
            for p in seq:
                fetch(base, p)
        # the port's singletons first, then the reference's: each server
        # writes to its own package's
        for base in (purl, jurl):
            docs.append((json.loads(fetch(base, "/stats/ledger")[2]),
                         json.loads(fetch(base, "/stats/slo")[2])))
    (pl, ps), (jl, js) = docs
    assert pl["requests"] == jl["requests"] == len(seq)
    for k in ("tenants", "shapes"):
        assert set(pl[k]) == set(jl[k])
        for key in jl[k]:
            assert pl[k][key]["requests"] == jl[k][key]["requests"]
            assert pl[k][key]["errors"] == jl[k][key]["errors"]
    assert set(ps["series"]) == set(js["series"])
    for key, v in js["series"].items():
        assert ps["series"][key]["requests"] == v["requests"]
    for name, v in js["slos"].items():
        assert ps["slos"][name]["requests"] == v["requests"]
    reset_singletons()


def test_warm_and_replica_are_not_in_the_port_yet():
    from geomesa_tpu_torch.server import make_server

    tds, _ = memory_pair(n=50)
    with pytest.raises(NotImplementedError, match="item 5b"):
        make_server(tds, resident=True, warm=True)
    with pytest.raises(NotImplementedError, match="replication"):
        make_server(tds, replica=object())


def test_mesh_with_one_device_serves_single_card(tmp_path):
    """``mesh=True`` counts the cards: with fewer than two it serves
    single-card, as the reference does with one device."""
    reset_singletons(tmp_path)
    tds, jds = memory_pair(n=400, seed=3)
    from geomesa_tpu_torch.server import serve_background

    server, _ = serve_background(tds, resident=True, mesh=True)
    try:
        base = "http://%s:%d" % server.server_address[:2]
        doc = json.loads(fetch(base, "/stats/mesh")[2])
        assert doc["enabled"] is False and doc["types"] == {}
        assert json.loads(fetch(base, f"/count/gdelt?cql={q(BOX)}")[2])["count"] == \
            jds.count("gdelt", BOX)
    finally:
        server.shutdown()
        server.server_close()
    reset_singletons()
