"""Per-request cost ledger: who spends the device's time, on what.

Counterpart of ``geomesa_tpu/ledger.py``. Three pieces:

- **Request cost collection.** The server installs a :class:`RequestCost`
  per request (:func:`collect_cost`, a contextvar like the tracing and
  degradation collectors); instrumented sites call :func:`charge` with a
  field of :data:`FIELDS`. The collector crosses thread pools explicitly
  (:func:`capture_cost` / :func:`attach_cost`: the scheduler and the
  prefetch pipeline carry it), and the riders of a fused launch are each
  charged their fair share (duration / riders), so summing over requests
  gives the device time actually spent.
- **Compile attribution.** The port runs eagerly; its only compile is the
  first-use ``nvcc`` build of a kernel library (``kernels/_build.py``).
  :func:`install` hooks those builds: an ``nvcc`` run records its seconds
  under the active :func:`compile_scope` signature (the request's query
  shape otherwise) and charges the request that waited on it, with a
  retroactive ``kernel.build`` span in its trace; a library found
  already built counts as a cache hit.
- **Aggregation.** Finished requests fold into the process-wide
  :class:`CostLedger`: per-tenant and per-shape aggregates (bounded key
  spaces, overflow collapsing into ``"other"``) with latency buckets for
  p50/p99, and a top-K ring of the most expensive requests with their
  trace ids (``/stats/ledger``).

The fold is gated by ``ledger.enabled``; the SLO engine reads the same
collector under its own ``slo.enabled``.
"""

from __future__ import annotations

import contextvars
import time
from bisect import bisect_left
from collections import OrderedDict
from contextlib import contextmanager

from geomesa_tpu_torch.locking import checked_lock

__all__ = [
    "FIELDS",
    "RequestCost",
    "CostLedger",
    "CompileLedger",
    "LEDGER",
    "COMPILES",
    "attach_cost",
    "capture_cost",
    "charge",
    "collect_cost",
    "compile_scope",
    "current_cost",
    "enabled",
    "finish_request",
    "install",
]

#: the ledger field registry: every ``charge`` names one of these
FIELDS = (
    "device_launches",   # device scan launches this request rode
    "device_seconds",    # fair-share device execution time (dur/riders)
    "fusion_width",      # widest fused launch this request rode (max)
    "compiles",          # kernel builds (nvcc runs) this request blocked on
    "compile_seconds",   # time spent blocked on those builds
    "compile_cache_hits",  # kernel libraries found already built
    "read_bytes",        # partition-file bytes read for this request
    "read_seconds",      # host read time (prefetch workers included)
    "decode_seconds",    # partition-file bytes to FeatureBatch decode time
    "stage_bytes",       # host column bytes staged for device scans
    "stage_seconds",     # host column staging time
    "chunks_read",       # v2 chunks actually read
    "chunks_pruned",     # v2 chunks skipped before read/decode
    "retries",           # serving-path retries spent (resilience.py)
    "degraded",          # degradation rungs taken (note_degraded count)
    "wal_bytes",         # write-ahead-log bytes this append durably wrote
    "wal_fsyncs",        # WAL fsync calls this append waited on
    "memtable_rows",     # rows this append landed in the live memtable
    "compact_seconds",   # background compaction seconds (system requests)
    "join_candidates",   # candidate pairs expanded by join refinement
    "join_pairs",        # pairs this request's spatial joins emitted
    "encode_seconds",    # wire-format serialization time (http.encode)
    "response_bytes",    # response body bytes written to the socket
    "replica_ship_bytes",  # WAL record bytes shipped to followers
    "replica_apply_rows",  # rows applied from a leader's shipped WAL
    "snapshot_ship_bytes",  # snapshot stream bytes shipped to a fetcher
    "sub_matches",       # matched alert rows charged to the subscriber
    "sub_deliver_bytes",  # push-stream bytes delivered to a subscriber
)

#: fields folded with max() instead of sum() (a request's fusion width
#: is the widest launch it rode, not the total of all of them)
_MAX_FIELDS = frozenset({"fusion_width"})

_FIELD_SET = frozenset(FIELDS)

#: per-aggregate latency buckets (seconds) for the ledger's p50/p99
#: summaries — coarser than the metrics histograms on purpose (one
#: array per tenant/shape, bounded key spaces)
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

#: bounded aggregate key spaces: pressure past these collapses new keys
#: into "other" (a tenant id is client-controlled input — an unbounded
#: dict would be an allocation amplifier)
_MAX_TENANTS = 256
_MAX_SHAPES = 64
_TOPK_RING = 16


def enabled() -> bool:
    from geomesa_tpu_torch.conf import sys_prop

    return bool(sys_prop("ledger.enabled"))


class RequestCost:
    """One request's cost accumulator. Charged from the handler thread,
    scheduler workers and prefetch workers concurrently — every
    mutation happens under the instance lock."""

    __slots__ = (
        "fields", "tenant", "endpoint", "lane", "shape", "trace_id",
        "status", "dur_s", "_lock",
    )

    def __init__(
        self, tenant: str = "", endpoint: str = "", lane: str = "",
        shape: str = "", trace_id: str = "",
    ):
        self.fields: dict = {}
        self.tenant = tenant
        self.endpoint = endpoint
        self.lane = lane
        self.shape = shape
        self.trace_id = trace_id
        self.status = 0
        self.dur_s = 0.0
        self._lock = checked_lock("ledger.cost")

    def charge(self, field: str, amount: float) -> None:
        if field not in _FIELD_SET:
            raise KeyError(f"unknown ledger field {field!r} (see FIELDS)")
        with self._lock:
            if field in _MAX_FIELDS:
                self.fields[field] = max(
                    self.fields.get(field, 0.0), float(amount)
                )
            else:
                self.fields[field] = (
                    self.fields.get(field, 0.0) + float(amount)
                )

    def snapshot_fields(self) -> dict:
        with self._lock:
            return dict(self.fields)

    def weight_s(self) -> float:
        """The cost rank used by the top-K ring: seconds of machine time
        this request consumed (device + compile + host I/O stages)."""
        f = self.snapshot_fields()
        return (
            f.get("device_seconds", 0.0)
            + f.get("compile_seconds", 0.0)
            + f.get("read_seconds", 0.0)
            + f.get("decode_seconds", 0.0)
            + f.get("stage_seconds", 0.0)
        )

    def to_dict(self) -> dict:
        f = self.snapshot_fields()
        return {
            "tenant": self.tenant,
            "endpoint": self.endpoint,
            "lane": self.lane,
            "shape": self.shape,
            "trace_id": self.trace_id,
            "status": self.status,
            "duration_ms": round(self.dur_s * 1e3, 3),
            "cost_s": round(self.weight_s(), 6),
            "fields": {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in sorted(f.items())
            },
        }


#: the per-request collector; None outside a serving request
_cost: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_torch_cost", default=None
)

@contextmanager
def collect_cost(**meta):
    """Install a fresh :class:`RequestCost` for the request (server
    request loop); yields it. The collector is installed even with
    ``ledger.enabled=False``: the SLO engine reads the request's
    endpoint/lane/status from it (the two switches are independent —
    :func:`finish_request` skips only the LEDGER fold when disabled),
    and a dropped-on-the-floor charge costs a dict add."""
    cost = RequestCost(**meta)
    token = _cost.set(cost)
    try:
        yield cost
    finally:
        _cost.reset(token)


def current_cost() -> "RequestCost | None":
    return _cost.get()


def charge(field: str, amount: float) -> None:
    """Charge the current request's ledger (no-op outside a request or
    with the ledger disabled). ``field`` must be a :data:`FIELDS` name."""
    cost = _cost.get()
    if cost is not None:
        cost.charge(field, amount)


def capture_cost() -> "RequestCost | None":
    """The current cost collector, for EXPLICIT propagation onto worker
    threads (same discipline as tracing.capture / capture_degraded)."""
    return _cost.get()


@contextmanager
def attach_cost(cost):
    """Attach a captured collector around work executing on another
    thread (scheduler / prefetch workers); None attaches nothing."""
    if cost is None:
        yield
        return
    token = _cost.set(cost)
    try:
        yield
    finally:
        _cost.reset(token)


# -- compile-time attribution -----------------------------------------------

_scope: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_torch_compile_scope", default=None
)


@contextmanager
def compile_scope(signature: str):
    """Tag any kernel build triggered in the body with ``signature`` (a
    bounded kernel-family string), so the compile ledger attributes build
    time to query shapes, not just to whole requests."""
    token = _scope.set(str(signature))
    try:
        yield
    finally:
        _scope.reset(token)


class CompileLedger:
    """Process-wide compilation ledger, fed by the kernel builds
    (:func:`install`): every ``nvcc`` run (on the thread that blocked on
    it) records under the active :func:`compile_scope` signature, charges
    the in-flight request that waited, and attaches a retroactive
    ``kernel.build`` span to its trace."""

    def __init__(self, max_signatures: int = 128):
        self.max_signatures = max_signatures
        self._lock = checked_lock("ledger.compile")
        self._by_sig: OrderedDict = OrderedDict()
        self.compiles = 0
        self.total_s = 0.0
        self.cache_hits = 0

    def _signature(self) -> str:
        sig = _scope.get()
        if sig:
            return sig
        cost = _cost.get()
        if cost is not None and cost.shape:
            return f"request:{cost.shape}"
        return "untagged"

    def on_backend_compile(self, dur_s: float) -> None:
        sig = self._signature()
        cost = _cost.get()
        trace_id = cost.trace_id if cost is not None else ""
        with self._lock:
            ent = self._by_sig.get(sig)
            if ent is None:
                if len(self._by_sig) >= self.max_signatures:
                    sig = "other"
                    ent = self._by_sig.get(sig)
                if ent is None:
                    ent = self._by_sig[sig] = {
                        "compiles": 0, "total_s": 0.0, "max_s": 0.0,
                        "cache_hits": 0, "last_trace_id": "",
                    }
            ent["compiles"] += 1
            ent["total_s"] += dur_s
            ent["max_s"] = max(ent["max_s"], dur_s)
            if trace_id:
                ent["last_trace_id"] = trace_id
            self.compiles += 1
            self.total_s += dur_s
        from geomesa_tpu_torch import metrics

        metrics.compile_events.inc()
        metrics.compile_event_seconds.inc(dur_s)
        if cost is not None:
            cost.charge("compiles", 1)
            cost.charge("compile_seconds", dur_s)
        # the compile happened INSIDE the request's wall time: stamp it
        # into the trace retroactively so the span tree shows exactly
        # which compile ate the budget
        try:
            from geomesa_tpu_torch import tracing

            sp = tracing.current_span()
            if sp is not None:
                tracing.record_span(
                    sp, "kernel.build",
                    time.perf_counter() - dur_s, dur_s, signature=sig,
                )
        except Exception:  # pragma: no cover - tracing must not break jit
            pass

    def on_cache_hit(self) -> None:
        sig = self._signature()
        with self._lock:
            self.cache_hits += 1
            ent = self._by_sig.get(sig)
            if ent is not None:
                ent["cache_hits"] += 1
        cost = _cost.get()
        if cost is not None:
            cost.charge("compile_cache_hits", 1)

    def snapshot(self, top: int = 16) -> dict:
        with self._lock:
            sigs = {k: dict(v) for k, v in self._by_sig.items()}
            compiles, total_s = self.compiles, self.total_s
            hits = self.cache_hits
        ranked = sorted(
            sigs.items(), key=lambda kv: kv[1]["total_s"], reverse=True
        )[: max(top, 0)]
        return {
            "compiles": compiles,
            "total_s": round(total_s, 4),
            "cache_hits": hits,
            "by_signature": {
                k: {
                    "compiles": v["compiles"],
                    "total_s": round(v["total_s"], 4),
                    "max_s": round(v["max_s"], 4),
                    "cache_hits": v["cache_hits"],
                    "last_trace_id": v["last_trace_id"],
                }
                for k, v in ranked
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._by_sig.clear()
            self.compiles = 0
            self.total_s = 0.0
            self.cache_hits = 0


_installed = False


def install() -> None:
    """Feed the compile ledger from the kernel builds (idempotent; called
    by make_server): every ``nvcc`` run of ``kernels/_build.py`` records
    its seconds as a compile, and every library found already built as a
    cache hit."""
    global _installed
    if _installed:
        return
    _installed = True
    from geomesa_tpu_torch.kernels import _build

    def _on_build(name: str, built: bool, dur_s: float) -> None:
        if built:
            COMPILES.on_backend_compile(float(dur_s))
        else:
            COMPILES.on_cache_hit()

    _build.add_build_listener(_on_build)


# -- process-wide aggregation -----------------------------------------------


class _Agg:
    """One aggregate bucket (a tenant or a query shape)."""

    __slots__ = ("requests", "errors", "fields", "lat_counts", "lat_sum")

    def __init__(self):
        self.requests = 0
        self.errors = 0
        self.fields: dict = {}
        self.lat_counts = [0] * (len(LATENCY_BUCKETS) + 1)
        self.lat_sum = 0.0

    def fold(self, cost: RequestCost, fields: dict) -> None:
        self.requests += 1
        if cost.status >= 500:
            self.errors += 1
        for k, v in fields.items():
            if k in _MAX_FIELDS:
                self.fields[k] = max(self.fields.get(k, 0.0), v)
            else:
                self.fields[k] = self.fields.get(k, 0.0) + v
        self.lat_counts[bisect_left(LATENCY_BUCKETS, cost.dur_s)] += 1
        self.lat_sum += cost.dur_s

    def quantile_ms(self, q: float) -> "float | None":
        """Bucket-upper-bound quantile (prometheus-style estimate)."""
        n = self.requests
        if n <= 0:
            return None
        rank = q * n
        cum = 0
        for i, c in enumerate(self.lat_counts):
            cum += c
            if cum >= rank and c:
                if i < len(LATENCY_BUCKETS):
                    return round(LATENCY_BUCKETS[i] * 1e3, 3)
                return round(
                    max(LATENCY_BUCKETS[-1], self.lat_sum / n) * 1e3, 3
                )
        return round(LATENCY_BUCKETS[-1] * 1e3, 3)

    def to_dict(self) -> dict:
        return {
            "requests": self.requests,
            "errors": self.errors,
            "p50_ms": self.quantile_ms(0.5),
            "p99_ms": self.quantile_ms(0.99),
            "mean_ms": (
                round(self.lat_sum / self.requests * 1e3, 3)
                if self.requests
                else None
            ),
            "cost": {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in sorted(self.fields.items())
            },
        }


class CostLedger:
    """Per-tenant / per-shape aggregates + the top-K expensive-request
    ring. The module global :data:`LEDGER` is the serving one; tests
    may build their own."""

    def __init__(self):
        self._lock = checked_lock("ledger.registry")
        self._tenants: dict = {}
        self._shapes: dict = {}
        self._top: list = []  # RequestCost.to_dict()s, by cost_s desc
        self.requests = 0

    @staticmethod
    def _key(table: dict, key: str, cap: int) -> str:
        if key in table or len(table) < cap:
            return key
        return "other"

    def record(self, cost: RequestCost) -> None:
        fields = cost.snapshot_fields()
        with self._lock:
            self.requests += 1
            tk = self._key(self._tenants, cost.tenant or "-", _MAX_TENANTS)
            self._tenants.setdefault(tk, _Agg()).fold(cost, fields)
            sk = self._key(self._shapes, cost.shape or "-", _MAX_SHAPES)
            self._shapes.setdefault(sk, _Agg()).fold(cost, fields)
            doc = cost.to_dict()
            self._top.append(doc)
            self._top.sort(key=lambda d: d["cost_s"], reverse=True)
            del self._top[_TOPK_RING:]
        from geomesa_tpu_torch import metrics

        metrics.ledger_requests.inc()
        metrics.ledger_device_seconds.inc(
            fields.get("device_seconds", 0.0)
        )
        metrics.ledger_compile_seconds.inc(
            fields.get("compile_seconds", 0.0)
        )

    @staticmethod
    def _ranked(table: dict, top: int) -> dict:
        """Rank already-serialized aggregate docs by machine-time cost."""
        def cost_of(doc: dict) -> float:
            c = doc["cost"]
            return (
                c.get("device_seconds", 0.0)
                + c.get("compile_seconds", 0.0)
                + c.get("read_seconds", 0.0)
            )

        ranked = sorted(
            table.items(), key=lambda kv: cost_of(kv[1]), reverse=True
        )
        return dict(ranked[: max(top, 0)])

    def snapshot(self, top: "int | None" = None) -> dict:
        """The ``/stats/ledger`` document. Aggregates serialize UNDER
        the ledger lock: record() mutates the same ``_Agg.fields``
        dicts concurrently, and iterating them live would let a
        first-seen field key raise mid-scrape (the concurrent-writer
        discipline metrics.prometheus_text follows)."""
        if top is None:
            from geomesa_tpu_torch.conf import sys_prop

            top = int(sys_prop("ledger.topk"))
        with self._lock:
            tenants = {k: v.to_dict() for k, v in self._tenants.items()}
            shapes = {k: v.to_dict() for k, v in self._shapes.items()}
            top_reqs = list(self._top[: max(top, 0)])
            requests = self.requests
        return {
            "enabled": enabled(),
            "requests": requests,
            "tenants": self._ranked(tenants, top),
            "shapes": self._ranked(shapes, top),
            "top_requests": top_reqs,
            "compile": COMPILES.snapshot(top),
        }

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._shapes.clear()
            del self._top[:]
            self.requests = 0


LEDGER = CostLedger()
COMPILES = CompileLedger()


def finish_request(cost: "RequestCost | None", trace=None) -> None:
    """Finalize one request: stamp its latency from the finished trace,
    fold degradation stamps, feed the SLO engine, and aggregate into
    the process ledger. Called by the server AFTER the trace context
    exits (the span tree is complete at that point — this is the
    'assembled at trace completion' step). Best-effort by design.
    The two master switches are INDEPENDENT: ``ledger.enabled`` gates
    only the cost fold, the SLO observation is gated by ``slo.enabled``
    inside the engine."""
    if cost is None:
        return
    try:
        if trace is not None and trace.dur_s is not None:
            cost.dur_s = float(trace.dur_s)
            cost.trace_id = trace.trace_id
        if enabled():
            LEDGER.record(cost)
        from geomesa_tpu_torch import slo

        slo.ENGINE.observe(
            endpoint=cost.endpoint,
            lane=cost.lane,
            dur_s=cost.dur_s,
            error=cost.status >= 500,
            trace_id=cost.trace_id,
        )
        # a request that breached its lane's SLO threshold should be
        # inspectable: force-retain its trace so the /metrics exemplar
        # resolves in /debug/traces even when head-sampling declined
        d = slo.slo_for_lane(cost.lane)
        if (
            trace is not None
            and trace.recording
            and (cost.status >= 500 or cost.dur_s * 1e3 > d.threshold_ms)
        ):
            from geomesa_tpu_torch.tracing import TRACER

            TRACER.retain(trace)
    except Exception:  # pragma: no cover - accounting must not break
        pass
