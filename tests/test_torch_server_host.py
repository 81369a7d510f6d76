"""Port parity for the server's host modules, each against the JAX
package's under the same operations: ``slo`` (windowed histograms, burn
rates and the engine's documents under an injected clock, the flight
recorder's bundles), ``ledger`` (the roll-up, top-K and compile
documents), ``tracing`` (request ids, retention, exports), ``metrics.prometheus_text`` line for line,
``resilience`` (the breaker state machine, the taxonomy, the degradation
collector), the result plane (``negotiate_format``,
``with_extra_columns``, ``capped_batches``, ``bin_stream_chunks``), the
GeoJSON codec and ``feature_collection``, and ``jobs.scheduled_queries``.
"""

import json
import os
from contextlib import ExitStack, contextmanager

import numpy as np
import pytest
from _torch_fs_cases import props

from geomesa_tpu import ledger as jledger
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import resilience as jres
from geomesa_tpu import slo as jslo
from geomesa_tpu import tracing as jtracing
from geomesa_tpu_torch import ledger, metrics, resilience, slo, tracing


@contextmanager
def _trace_props(sample, slow_ms):
    """``trace.sample`` and ``trace.slow_ms`` in both packages."""
    from geomesa_tpu import conf as jconf
    from geomesa_tpu_torch import conf

    with ExitStack() as st:
        for c in (conf, jconf):
            st.enter_context(c.prop_override("trace.sample", sample))
            st.enter_context(c.prop_override("trace.slow_ms", slow_ms))
        yield


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _requests(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        out.append(dict(
            endpoint=["count", "features", "density", "knn", "append"][rng.integers(5)],
            lane=["interactive", "batch", "ingest", "nope", ""][rng.integers(5)],
            dur_s=float(rng.choice([0.0004, 0.003, 0.02, 0.3, 0.7, 4.0, 7.0, 40.0])),
            error=bool(rng.random() < 0.05),
            trace_id=f"t{i}",
            step=float(rng.choice([0.0, 1.0, 13.0, 61.0, 400.0])),
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_documents_equal_the_reference(seed, tmp_path):
    ca, cb = Clock(), Clock()
    with props(slo_flightrec_burn=0.0), slo.fresh_engine(ca) as ea, jslo.fresh_engine(cb) as eb:
        for r in _requests(seed):
            ca.t += r["step"]
            cb.t += r["step"]
            kw = {k: r[k] for k in ("endpoint", "lane", "dur_s", "error", "trace_id")}
            ea.observe(**kw)
            eb.observe(**kw)
            assert ea.burning() == eb.burning()
        assert ea.snapshot() == eb.snapshot()
        for name in slo.SLO_NAMES:
            d, jd = slo.slo_def(name), jslo.slo_def(name)
            for w in (60.0, 300.0, 3600.0):
                assert ea.burn(d, w) == eb.burn(jd, w)


@pytest.mark.parametrize("window,slots", [(60.0, 6), (3600.0, 60), (10.0, 1)])
def test_windowed_histogram_equals_the_reference(window, slots):
    ca, cb = Clock(5.0), Clock(5.0)
    ha = slo.WindowedHistogram(window, slots=slots, clock=ca)
    hb = jslo.WindowedHistogram(window, slots=slots, clock=cb)
    rng = np.random.default_rng(int(window))
    for _ in range(500):
        step = float(rng.exponential(window / 40))
        ca.t += step
        cb.t += step
        v = float(rng.lognormal(-4, 2))
        bad = bool(rng.random() < 0.1)
        ha.observe(v, bad)
        hb.observe(v, bad)
        w = float(rng.choice([window / 4, window / 2, window]))
        assert ha.merged(w) == hb.merged(w)
        for qq in (0.5, 0.99, 0.999):
            assert ha.quantile_ms(qq, w) == hb.quantile_ms(qq, w)


def test_flight_recorder_bundles_equal_the_reference(tmp_path):
    recs = []
    for mod in (slo, jslo):
        fr = mod.FlightRecorder()
        fr.configure(str(tmp_path / mod.__name__), providers={"extra": lambda: {"x": 1}})
        recs.append(fr)
    with props(slo_flightrec_keep=2, slo_flightrec_interval_s=3600.0):
        for reason in ("burn-rate", "burn-rate", "breaker-open", "unknown-thing", "ingest-stall"):
            got = [fr.trigger(reason, detail={"k": reason}) for fr in recs]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                assert os.path.basename(got[0])[16:] == os.path.basename(got[1])[16:]
                assert sorted(os.listdir(got[0])) == sorted(os.listdir(got[1]))
                ra = json.load(open(os.path.join(got[0], "reason.json")))
                rb = json.load(open(os.path.join(got[1], "reason.json")))
                assert (ra["reason"], ra["detail"]) == (rb["reason"], rb["detail"])
        assert [n[16:] for n in recs[0].bundle_names()] == [n[16:] for n in recs[1].bundle_names()]
        assert recs[0].bundles == recs[1].bundles == 4
    with props(slo_enabled=False):
        assert recs[0].trigger("manual") is None and recs[1].trigger("manual") is None


def _costs(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        c = mod.RequestCost(tenant=f"ten{rng.integers(0, 300)}" if rng.random() < 0.5 else "a",
                            endpoint="count", lane="interactive",
                            shape=f"count:S{rng.integers(0, 80)}", trace_id=f"tr{i}")
        for f in ("device_seconds", "read_seconds", "device_launches", "fusion_width",
                  "degraded", "read_bytes"):
            c.charge(f, float(rng.integers(0, 100)) / 8)
        c.status = int(rng.choice([200, 200, 429, 500]))
        c.dur_s = float(rng.choice([0.0005, 0.02, 0.4, 3.0, 50.0]))
        out.append(c)
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_cost_ledger_documents_equal_the_reference(seed):
    la, lb = ledger.CostLedger(), jledger.CostLedger()
    for a, b in zip(_costs(ledger, seed), _costs(jledger, seed)):
        la.record(a)
        lb.record(b)
    for top in (3, 10, 100):
        sa, sb = la.snapshot(top), lb.snapshot(top)
        sa.pop("compile"), sb.pop("compile")
        assert sa == sb
    with pytest.raises(KeyError):
        ledger.RequestCost().charge("no_such_field", 1)


def test_compile_ledger_equals_the_reference():
    ca, cb = ledger.CompileLedger(max_signatures=3), jledger.CompileLedger(max_signatures=3)
    for mod, cl in ((ledger, ca), (jledger, cb)):
        with mod.collect_cost(shape="count:BBOX", trace_id="x1") as cost:
            cl.on_backend_compile(1.5)
            with mod.compile_scope("cache.scan"):
                cl.on_backend_compile(0.25)
                cl.on_cache_hit()
            for sig in ("a", "b", "c", "d"):
                with mod.compile_scope(sig):
                    cl.on_backend_compile(0.125)
        cl.on_backend_compile(2.0)
        cl.on_cache_hit()
        assert cost.snapshot_fields() == {"compiles": 6.0, "compile_seconds": 2.25,
                                          "compile_cache_hits": 1.0}
    assert ca.snapshot() == cb.snapshot()
    assert ca.snapshot(top=2) == cb.snapshot(top=2)


def test_tracer_ids_retention_and_exports_equal_the_reference(tmp_path):
    for raw in (None, "", "abc", "a b/<c>\"d", "x" * 100, "é-ok_1.2:3", "\n\t"):
        assert tracing._clean_id(raw) == jtracing._clean_id(raw)
    docs = []
    for mod in (tracing, jtracing):
        tr = mod.Tracer(capacity=3)
        tr.slow_log_path = str(tmp_path / mod.__name__ / "_slow_queries.jsonl")
        kept = []
        with _trace_props(0.0, 0.0):
            with tr.trace("off", trace_id="off-1") as t:
                assert not t.recording and mod.current_span() is None
        with _trace_props(1.0, 0.0):
            for i in range(5):
                with tr.trace(f"req{i}", trace_id=f"id-{i}", attrs={"i": i}) as t:
                    with mod.span("child", k=1) as sp:
                        sp.set(rows=3)
                    mod.record_span(mod.capture(), "late", t.t0, 0.001, w=2)
                kept.append(t)
        with _trace_props(0.0, 0.000001):
            with tr.trace("slow", trace_id="slow-1"):
                sum(range(1000))
        recent = tr.recent(10)
        docs.append(([(r["trace_id"], r["name"], r["sampled"], r["slow"]) for r in recent],
                     tr.get("id-4").to_dict(), tr.get("id-4").to_perfetto(),
                     [json.loads(line)["trace_id"] for line in open(tr.slow_log_path)]))
    a, b = docs
    assert a[0] == b[0] == [("slow-1", "slow", False, True), ("id-4", "req4", True, False),
                            ("id-3", "req3", True, False)]
    strip = _strip_times
    assert strip(a[1]) == strip(b[1])
    ev = [(e["name"], e["ph"], e["tid"], e.get("args")) for e in a[2]["traceEvents"]]
    jev = [(e["name"], e["ph"], e["tid"], e.get("args")) for e in b[2]["traceEvents"]]
    assert ev == jev and a[2]["otherData"] == b[2]["otherData"]
    assert a[3] == b[3] == ["slow-1"]


def _strip_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_times(v) for k, v in doc.items()
                if k not in ("ts", "start_ms", "dur_ms", "duration_ms", "thread")}
    if isinstance(doc, list):
        return [_strip_times(v) for v in doc]
    return doc


def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("geomesa_x_total", "things done")
    g = reg.gauge("geomesa_depth", "")
    h = reg.histogram("geomesa_lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    c.inc()
    c.inc(2.5, endpoint="count", lane='q"uote\\back\nline')
    g.set(3, domain="device")
    g.inc(-1.25, domain="cache")
    g.dec(2)
    for i, v in enumerate((0.001, 0.05, 0.05, 2.0, 0.5)):
        h.observe(v, exemplar={"trace_id": f"t{i}"} if i % 2 == 0 else None, endpoint="count")
    h.observe(0.2)
    return reg


def test_prometheus_text_equals_the_reference_line_for_line():
    a, b = _exercise(metrics), _exercise(jmetrics)
    for om in (False, True):
        assert a.prometheus_text(openmetrics=om).splitlines() == \
            b.prometheus_text(openmetrics=om).splitlines()
    assert "# EOF" in a.prometheus_text(openmetrics=True)
    assert " # {" not in a.prometheus_text()


def test_circuit_breaker_and_degradation_collector_equal_the_reference():
    ca, cb = Clock(), Clock()
    out = []
    for mod, clk in ((resilience, ca), (jres, cb)):
        import time as _t

        br = mod.CircuitBreaker("x", failures=2, cooldown_s=1.0)
        real = _t.monotonic
        states = []
        try:
            _t.monotonic = clk
            for step in ("f", "f", "a", "t", "a", "f", "t", "a", "a", "r", "a", "s", "a"):
                if step == "f":
                    br.record_failure()
                elif step == "s":
                    br.record_success()
                elif step == "r":
                    br.release_probe()
                elif step == "t":
                    clk.t += 1.5
                else:
                    states.append(br.allow())
                states.append(br.snapshot())
        finally:
            _t.monotonic = real
        out.append(states)
        with mod.collect_degraded() as reasons:
            mod.note_degraded("device-launch-failed")
            mod.note_degraded("device-launch-failed")
            mod.note_degraded("made-up")
            assert mod.current_degraded() == reasons
        assert mod.current_degraded() == []
        out.append(reasons)
    assert out[0] == out[2] and out[1] == out[3]


def test_fault_taxonomy_equals_the_reference():
    from geomesa_tpu import failpoints as jfp
    from geomesa_tpu.sched import DeadlineExpired as JDeadline
    from geomesa_tpu.sched import RejectedError as JRejected
    from geomesa_tpu.store.fs import PartitionCorruptError as JCorrupt
    from geomesa_tpu_torch import failpoints
    from geomesa_tpu_torch.sched import DeadlineExpired, RejectedError
    from geomesa_tpu_torch.store.fs import PartitionCorruptError

    pairs = [
        (RejectedError(1.0), JRejected(1.0)), (DeadlineExpired("x"), JDeadline("x")),
        (resilience.LaunchStuckError("x"), jres.LaunchStuckError("x")),
        (resilience.PartitionUnavailableError("t", 1, "c"), jres.PartitionUnavailableError("t", 1, "c")),
        (MemoryError(), MemoryError()), (FileNotFoundError(), FileNotFoundError()),
        (OSError("io"), OSError("io")), (failpoints.FailpointError("f"), jfp.FailpointError("f")),
        (ValueError("v"), ValueError("v")), (KeyError("k"), KeyError("k")),
        (RuntimeError("x"), RuntimeError("x")),
        (PartitionCorruptError("t", 1, "p", "bad"), JCorrupt("t", 1, "p", "bad")),
    ]
    for a, b in pairs:
        assert resilience.classify(a) == jres.classify(b), type(a).__name__
    from geomesa_tpu_torch.kernels import KernelLaunchError

    assert resilience.classify(KernelLaunchError("gm_zscan: CUDA error 700")) == resilience.RETRYABLE
    resilience.reset()
    jres.reset()
    snap, jsnap = resilience.snapshot(), jres.snapshot()
    assert snap == jsnap
    assert resilience.partition_breaker("r:t", 3) is resilience.partition_breaker("r:t", 3)
    assert resilience.open_partition_breakers() == 0
    resilience.reset()
    jres.reset()


NEGOTIATE = [
    ({}, None), ({"f": "json"}, None), ({"f": " BIN "}, None), ({"f": "arrow"}, None),
    ({"f": "xml"}, None), ({}, "application/vnd.apache.arrow.stream"),
    ({}, "text/html, application/vnd.geomesa.bin;q=0.5"),
    ({}, "application/vnd.geomesa.bin;q=0, application/geo+json"), ({}, "*/*"),
    ({}, "application/vnd.geomesa.bin;q=abc"), ({"f": "geojson"}, "application/vnd.geomesa.bin"),
]


@pytest.mark.parametrize("qd,accept", NEGOTIATE)
def test_negotiate_format_equals_the_reference(qd, accept):
    from geomesa_tpu.results import negotiate_format as jneg
    from geomesa_tpu_torch.results import negotiate_format

    def run(fn):
        try:
            return fn(dict(qd), accept)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(negotiate_format) == run(jneg)


def _batches(mods, n=40, seed=6):
    from _torch_fs_cases import rows

    cols = rows("z3", n, seed)
    cols["val"][3] = np.nan
    out = []
    for fb, sft in mods:
        s = sft.create("t", "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326")
        out.append(fb.from_columns(s, cols, fids=np.arange(n)))
    return out


def _mods():
    from geomesa_tpu.features.batch import FeatureBatch as JB
    from geomesa_tpu.features.sft import SimpleFeatureType as JS
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    return [(FeatureBatch, SimpleFeatureType), (JB, JS)]


def test_result_plane_helpers_equal_the_reference():
    from geomesa_tpu import results as jresults
    from geomesa_tpu.export import feature_collection as jfc
    from geomesa_tpu_torch import results
    from geomesa_tpu_torch.export import feature_collection

    a, b = _batches(_mods())
    d = np.linspace(0, 1, len(a))
    ea = results.with_extra_columns(a, {"knn_distance_deg": d, "rank": np.arange(len(a))})
    eb = jresults.with_extra_columns(b, {"knn_distance_deg": d, "rank": np.arange(len(b))})
    assert ea.sft.spec == eb.sft.spec
    ta, tb = json.dumps(feature_collection(ea)), json.dumps(jfc(eb))
    assert ta == tb and "NaN" not in ta
    with pytest.raises(ValueError):
        results.with_extra_columns(a, {"name": d})
    parts = [a.take(np.arange(i, min(i + 7, len(a)))) for i in range(0, len(a), 7)]
    jparts = [b.take(np.arange(i, min(i + 7, len(b)))) for i in range(0, len(b), 7)]
    for cap in (None, 0, 5, 7, 13, 100):
        got = [list(x.fids) for x in results.capped_batches(iter(parts), cap)]
        want = [list(x.fids) for x in jresults.capped_batches(iter(jparts), cap)]
        assert got == want
    for kw in ({}, {"sort": True}, {"label_attr": "name"}):
        assert b"".join(results.bin_stream_chunks(parts, "name", **kw)) == \
            b"".join(jresults.bin_stream_chunks(jparts, "name", **kw))


def test_geojson_codec_equals_the_reference():
    from geomesa_tpu.geom import geojson as jgj
    from geomesa_tpu.geom.wkt import parse_wkt as jparse
    from geomesa_tpu_torch.geom import geojson as gj
    from geomesa_tpu_torch.geom.wkt import parse_wkt

    for wkt in ("POINT (1.5 -2)", "LINESTRING (0 0, 1 1, 2 0.5)",
                "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 1))",
                "MULTIPOINT ((1 2), (3 4))", "MULTILINESTRING ((0 0, 1 1), (2 2, 3 1))",
                "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5)))"):
        doc = gj.to_geojson(parse_wkt(wkt))
        assert doc == jgj.to_geojson(jparse(wkt))
        assert gj.to_geojson(gj.from_geojson(json.dumps(doc))) == doc


def test_scheduled_queries_equal_serial_and_the_reference():
    from geomesa_tpu.jobs import scheduled_queries as jsq
    from geomesa_tpu_torch.jobs import scheduled_queries
    from geomesa_tpu_torch.sched import QueryScheduler, SchedConfig
    from _torch_server_cases import memory_pair

    from geomesa_tpu.device_cache import DeviceIndex as JDI
    from geomesa_tpu_torch.device_cache import DeviceIndex

    tds, jds = memory_pair(n=1500, seed=31)
    di = DeviceIndex(tds, "gdelt", z_planes=True, device="cpu")
    jdi = JDI(jds, "gdelt", z_planes=True)
    qs = [f"BBOX(geom, {x}, {y}, {x + 30.5}, {y + 20.25})" for x in (-120, -40, 10, 60)
          for y in (-50, 0, 30)]
    serial = scheduled_queries(di, qs, loose=True)
    with QueryScheduler(SchedConfig(max_queue=4, fusion_window_ms=5.0)) as sched:
        fused = scheduled_queries(di, qs, sched, loose=True)
        rows = scheduled_queries(di, qs[:3], sched, op="query", loose=True, auths=("A",))
    assert fused == serial == jsq(jdi, qs, loose=True)
    want = jsq(jdi, qs[:3], op="query", loose=True, auths=("A",))
    assert [list(r.fids) for r in rows] == [list(r.fids) for r in want]
