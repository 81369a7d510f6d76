"""Metrics registry of the port's serving path, with Prometheus text
exposition.

Counterpart of ``geomesa_tpu/metrics.py``: Counter, Gauge and Histogram
(with OpenMetrics exemplars) with labels, one
process-global registry and :meth:`MetricsRegistry.prometheus_text`
(reference line 147: the classic 0.0.4 text, or OpenMetrics with
exemplars and ``# EOF``). The metrics are those the port writes: the
device query scheduler and its watchdog (queue depth, wait time,
queries, launches, fused queries, rejections, expirations, worker
failures, drains, watchdog timeouts); the streaming index's delta
refreshes by mode; the spatial join engine's counters and histograms and
the device BIN pack's launches (reference lines 644-697); the store
path's queries, query latency and OOM recoveries; the file-system
store's host I/O (``io_*``), generations, recovery sweeps, checksums and
quarantines (``store_*``) and its aggregation pushdown
(``agg_pushdown_*``, reference lines 280-380); the serving retries,
breakers and degradations (``resilience_*``) and the streaming live
layer's appends, WAL, replay, memtable, backpressure and compaction
(``stream_*``, reference lines 547-596); and the server's own families
(reference lines 484-546 and 679-694): traces and slow queries, the SLO
engine's windows and burn rates, flight-recorder bundles, the cost
ledger, the kernel builds the compile ledger counts, and the result
plane's encode/write split; the continuous-query push tier's
(``pubsub_*``, reference lines 796-840); and the resident warmup's
progress gauge (``warmup_signatures``, reference lines 471-478). The
counterpart's other families
are left out.
"""

from __future__ import annotations

import threading
from bisect import bisect_left


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._values: dict = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> tuple:
        return tuple(sorted(labels.items()))


class Counter(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self.labels(**labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self.labels(**labels), 0.0)


class Gauge(_Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "gauge")

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self.labels(**labels)] = float(v)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self.labels(**labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self.labels(**labels), 0.0)


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


class Histogram(_Metric):
    """Bucketed histogram: per label set the count of each ``le`` bucket
    (the last slot is +Inf), the sum and the number of observations.
    ``observe(..., exemplar={"trace_id": tid})`` attaches an OpenMetrics
    exemplar to the bucket the value lands in (last writer wins)."""

    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))

    def observe(self, v: float, *, exemplar=None, **labels) -> None:
        key = self.labels(**labels)
        with self._lock:
            st = self._values.setdefault(
                key, {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "n": 0})
            b = bisect_left(self.buckets, v)
            st["counts"][b] += 1
            st["sum"] += v
            st["n"] += 1
            if exemplar:
                st.setdefault("exemplars", {})[b] = (dict(exemplar), float(v))

    def stats(self, **labels) -> dict:
        return self._values.get(self.labels(**labels), {"counts": [], "sum": 0.0, "n": 0})


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, buckets), Histogram)

    def _get(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is a {m.kind}")
            return m

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """Prometheus exposition: the classic text format (0.0.4) without
        exemplars by default, whose parser rejects anything after the
        value; ``openmetrics=True`` adds the exemplar suffixes on
        histogram buckets and the closing ``# EOF``. Every value is
        snapshotted under its metric's lock before formatting."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                with m._lock:
                    values = sorted(m._values.items())
                for key, v in values:
                    lines.append(f"{name}{_fmt_labels(key)} {_fmt_val(v)}")
                continue
            with m._lock:
                stats = sorted(
                    (key, list(st["counts"]), st["sum"], st["n"], dict(st.get("exemplars", ())))
                    for key, st in m._values.items())
            for key, counts, total, n, exemplars in stats:
                cum = 0
                for i, (b, c) in enumerate(zip(m.buckets + (float("inf"),), counts)):
                    cum += c
                    lb = "+Inf" if b == float("inf") else _fmt_val(b)
                    line = f"{name}_bucket{_fmt_labels(key + (('le', lb),))} {cum}"
                    ex = exemplars.get(i) if openmetrics else None
                    if ex is not None:
                        line += f" # {_fmt_labels(tuple(sorted(ex[0].items())))} {_fmt_val(ex[1])}"
                    lines.append(line)
                lines.append(f"{name}_sum{_fmt_labels(key)} {_fmt_val(total)}")
                lines.append(f"{name}_count{_fmt_labels(key)} {n}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"



def _esc_label(v) -> str:
    """Label value escaping (backslash, double quote, newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_esc_label(v)}"' for k, v in key) + "}"


def _fmt_val(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


REGISTRY = MetricsRegistry()

# device query scheduler (sched/): queue pressure, wait time, fusion
# factor (sched_queries_total / sched_launches_total) and shed load
sched_queue_depth = REGISTRY.gauge(
    "geomesa_sched_queue_depth", "requests waiting in the scheduler queue")
sched_queries = REGISTRY.counter(
    "geomesa_sched_queries_total", "requests executed by the scheduler")
sched_launches = REGISTRY.counter(
    "geomesa_sched_launches_total", "device scan launches dispatched")
sched_fused = REGISTRY.counter(
    "geomesa_sched_fused_queries_total", "queries answered by a shared (fused) device launch")
sched_rejected = REGISTRY.counter(
    "geomesa_sched_rejections_total", "requests rejected at admission")
sched_expired = REGISTRY.counter(
    "geomesa_sched_deadline_expired_total", "requests that expired before or during execution")
sched_wait_seconds = REGISTRY.histogram(
    "geomesa_sched_wait_seconds", "queue wait before execution")
sched_worker_failures = REGISTRY.counter(
    "geomesa_sched_worker_failures_total",
    "scheduler worker crashes survived (requests failed typed, worker kept serving)")
sched_drains = REGISTRY.counter(
    "geomesa_sched_drains_total",
    "graceful drains completed (admission stopped, in-flight finished)")
resilience_retries = REGISTRY.counter(
    "geomesa_resilience_retries_total", "serving-path retries of retryable faults (by domain)")
resilience_watchdog_timeouts = REGISTRY.counter(
    "geomesa_resilience_watchdog_timeouts_total",
    "stuck device launches failed by the scheduler watchdog")
stream_delta_refreshes = REGISTRY.counter(
    "geomesa_stream_delta_refreshes_total",
    "resident-index refreshes from streamed appends, by mode "
    "(delta = incremental into the validity-planed buffers, "
    "restage = fallback full restage)")

# the streaming live layer (store/stream.py, store/wal.py): WAL-backed
# appends, the in-memory generation they serve from, and the backpressured
# compaction into the partition files
stream_appends = REGISTRY.counter("geomesa_stream_appends_total", "acked streaming append calls")
stream_rows = REGISTRY.counter("geomesa_stream_rows_total", "rows acked through the streaming layer")
stream_wal_bytes = REGISTRY.counter("geomesa_stream_wal_bytes_total", "bytes appended to WAL segments")
stream_wal_fsyncs = REGISTRY.counter(
    "geomesa_stream_wal_fsyncs_total", "WAL fsync calls (durability acks)")
stream_wal_replay_rows = REGISTRY.counter(
    "geomesa_stream_wal_replay_rows_total", "rows recovered into the memtable by WAL replay at open")
stream_wal_truncations = REGISTRY.counter(
    "geomesa_stream_wal_truncations_total",
    "torn WAL tails truncated at the last valid checksum during replay")
stream_memtable_rows = REGISTRY.gauge(
    "geomesa_stream_memtable_rows", "rows live in the in-memory generation (not yet compacted)")
stream_memtable_runs = REGISTRY.gauge(
    "geomesa_stream_memtable_runs", "Z-sorted memtable runs live (the per-query read amplification)")
stream_backpressure = REGISTRY.counter(
    "geomesa_stream_backpressure_total", "appends rejected 429-style at the wal.max.generations bound")
stream_compactions = REGISTRY.counter(
    "geomesa_stream_compactions_total", "memtable generations compacted into partition files")
stream_compact_seconds = REGISTRY.histogram(
    "geomesa_stream_compact_seconds", "background compaction duration (merge + flush + WAL truncate)")
stream_compact_yields = REGISTRY.counter(
    "geomesa_stream_compact_yields_total", "compactor pauses yielded to serving load (brownout signal)")

# spatial join engine (join/): joins by planner strategy, candidate and pair
# volumes, refinement launches, the skew-split escape, window_pairs_query's
# compaction-cap overflows, and plan/refine seconds
join_queries = REGISTRY.counter(
    "geomesa_join_queries_total", "spatial joins executed, by planner strategy")
join_candidates = REGISTRY.counter(
    "geomesa_join_candidates_total",
    "candidate (row, window) pairs expanded by join refinement")
join_pairs = REGISTRY.counter(
    "geomesa_join_pairs_total", "pairs emitted by the join engine")
join_launches = REGISTRY.counter(
    "geomesa_join_launches_total",
    "batched join refinement launches (count + compact each count one)")
join_skew_splits = REGISTRY.counter(
    "geomesa_join_skew_splits_total", "candidate runs split by the skew escape (hot-cell bound)")
join_pair_overflows = REGISTRY.counter(
    "geomesa_join_pair_overflows_total",
    "window-pairs groups whose compaction cap overflowed into a full bit-plane refetch")
join_plan_seconds = REGISTRY.histogram(
    "geomesa_join_plan_seconds", "join planning time (per join)")
join_refine_seconds = REGISTRY.histogram(
    "geomesa_join_refine_seconds",
    "join refinement time (expansion + launches + emission, per join)")
results_bin_device_launches = REGISTRY.counter(
    "geomesa_results_bin_device_launches_total",
    "device BIN pack calls (a count and a compaction count one)")

# the store path (store/memory.py, query/runner.py): queries run per store
# and type, their end-to-end latency, and scan runs recovered from an OOM
# by halving
queries_run = REGISTRY.counter("geomesa_queries_total", "queries executed")
query_seconds = REGISTRY.histogram(
    "geomesa_query_duration_seconds", "end-to-end query latency")
resilience_oom_recoveries = REGISTRY.counter(
    "geomesa_resilience_oom_recoveries_total",
    "staging/HBM OOMs recovered by halving the scan batch")

# the file-system store's host-I/O pipeline (store/prefetch.py, store/fs.py):
# read and decode time per file, read-ahead depth, queue bytes, bytes read
io_read_seconds = REGISTRY.histogram(
    "geomesa_io_read_seconds", "partition file read time (per file)")
io_decode_seconds = REGISTRY.histogram(
    "geomesa_io_decode_seconds", "partition bytes to FeatureBatch decode time (per file)")
io_prefetch_depth = REGISTRY.gauge("geomesa_io_prefetch_depth", "prefetch items in flight")
io_queue_bytes = REGISTRY.gauge(
    "geomesa_io_queue_bytes", "decoded bytes waiting in the prefetch queue")
io_chunks = REGISTRY.counter(
    "geomesa_io_chunks_total", "items delivered by the prefetch pipeline")
io_bytes_read = REGISTRY.counter(
    "geomesa_io_bytes_read_total", "partition file bytes read from disk")

# the crash-consistent file-system store (store/fs.py): generations
# published, what the recovery sweep reclaimed, checksum failures and the
# partitions they quarantined, transient-read retries, chunk-stat drift
store_generations = REGISTRY.counter(
    "geomesa_store_generations_published_total",
    "partition-file generations atomically published by flushes")
store_orphan_files = REGISTRY.counter(
    "geomesa_store_orphan_files_reclaimed_total",
    "orphaned partition/tmp files reclaimed by the recovery sweep")
store_orphan_bytes = REGISTRY.counter(
    "geomesa_store_orphan_bytes_reclaimed_total", "bytes reclaimed by the recovery sweep")
store_checksum_failures = REGISTRY.counter(
    "geomesa_store_checksum_failures_total", "partition files that failed checksum verification")
store_quarantined = REGISTRY.gauge(
    "geomesa_store_partitions_quarantined",
    "partitions quarantined by checksum failures (summed over store objects)")
store_read_retries = REGISTRY.counter(
    "geomesa_store_read_retries_total", "transient partition-read retries by the prefetch workers")
store_chunks_read = REGISTRY.counter(
    "geomesa_store_chunks_read_total", "v2 partition chunks read by chunk-selective reads")
store_chunks_skipped = REGISTRY.counter(
    "geomesa_store_chunks_skipped_total", "v2 partition chunks pruned before read/decode")
store_chunk_bytes_skipped = REGISTRY.counter(
    "geomesa_store_chunk_bytes_skipped_total", "partition-file bytes skipped by chunk pruning")
store_chunk_stat_drift = REGISTRY.counter(
    "geomesa_store_chunk_stat_drift_total",
    "chunk-stat records that disagreed with decoded rows (verify_chunk_stats)")

# aggregation pushdown (store/pushdown.py): aggregates answered from chunk
# pre-aggregates by kind, fallbacks to the row scan, interior rows never
# read, boundary chunks refined by the filter scan
agg_pushdown_queries = REGISTRY.counter(
    "geomesa_agg_pushdown_queries_total", "aggregate queries answered from chunk pre-aggregates")
agg_pushdown_fallbacks = REGISTRY.counter(
    "geomesa_agg_pushdown_fallback_total", "aggregate queries that fell back to the row scan")
agg_pushdown_rows = REGISTRY.counter(
    "geomesa_agg_pushdown_rows_preaggregated_total",
    "rows answered from interior-chunk summaries without being read")
agg_pushdown_chunks_refined = REGISTRY.counter(
    "geomesa_agg_pushdown_chunks_refined_total",
    "boundary chunks that descended to row-level refinement")

# the server's families: retained traces and slow queries (tracing.py),
# the SLO engine's windows and burn (slo.py), flight-recorder bundles, the
# cost ledger and the compile ledger's kernel builds (ledger.py), breaker
# states and degradations (resilience.py), the result plane's encode/write
# split (server.py)
traces_captured = REGISTRY.counter(
    "geomesa_traces_captured_total", "request traces retained in the recent-trace ring")
slow_queries = REGISTRY.counter(
    "geomesa_slow_queries_total",
    "requests slower than trace.slow_ms (always-captured + slow-logged)")
slo_latency = REGISTRY.histogram(
    "geomesa_slo_latency_seconds",
    "request latency per endpoint/lane (buckets carry trace exemplars)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
slo_requests = REGISTRY.counter("geomesa_slo_requests_total", "requests measured against an SLO")
slo_bad = REGISTRY.counter(
    "geomesa_slo_bad_total", "requests over their SLO latency threshold or failed 5xx")
slo_burn = REGISTRY.gauge(
    "geomesa_slo_burn_rate",
    "error-budget burn rate per (slo, window); > 1 consumes budget faster than it accrues")
flightrec_bundles = REGISTRY.counter(
    "geomesa_flightrec_bundles_total", "flight-recorder postmortem bundles written, by reason")
ledger_requests = REGISTRY.counter(
    "geomesa_ledger_requests_total", "requests folded into the cost ledger")
ledger_device_seconds = REGISTRY.counter(
    "geomesa_ledger_device_seconds_total",
    "fair-share device seconds attributed to ledgered requests")
ledger_compile_seconds = REGISTRY.counter(
    "geomesa_ledger_compile_seconds_total", "kernel build seconds ledgered requests blocked on")
compile_events = REGISTRY.counter(
    "geomesa_compile_events_total", "kernel builds (nvcc runs) observed by the compile ledger")
compile_event_seconds = REGISTRY.counter(
    "geomesa_compile_event_seconds_total",
    "total kernel build seconds observed by the compile ledger")
# the resident warmup (warmup.py): progress of the start-time pass over
# the kernel families, by state label -- state="total" planned legs,
# state="compiled" legs that saw a kernel build (an nvcc run),
# state="from_cache" legs that found every library built, state="failed"
# legs that raised (reference metrics.py:471-478)
warmup_signatures = REGISTRY.gauge(
    "geomesa_warmup_signatures",
    "resident warmup legs by state (total/compiled/from_cache/failed)")
resilience_breaker_state = REGISTRY.gauge(
    "geomesa_resilience_breaker_state",
    "circuit-breaker state per domain (0=closed 1=half-open 2=open)")
resilience_breaker_transitions = REGISTRY.counter(
    "geomesa_resilience_breaker_transitions_total", "circuit-breaker state transitions (domain, to)")
resilience_degraded = REGISTRY.counter(
    "geomesa_resilience_degraded_total", "requests answered degraded, by (bounded) reason")
results_batches = REGISTRY.counter(
    "geomesa_results_batches_total",
    "wire record batches / chunks emitted by the result plane (fmt)")
results_bytes = REGISTRY.counter(
    "geomesa_results_bytes_total", "response/export body bytes encoded by the result plane (fmt)")
results_encode_seconds = REGISTRY.histogram(
    "geomesa_results_encode_seconds",
    "wire-format serialization time per response (socket write excluded)")
results_write_seconds = REGISTRY.histogram(
    "geomesa_results_write_seconds", "socket write time per response (serialization excluded)")

# the continuous-query push tier (pubsub/): the registry's size, the fused
# match a batch on the ingest path, delivery and replay volume, and the
# teardown and heartbeat accounting of long-lived push streams
pubsub_subscriptions = REGISTRY.gauge(
    "geomesa_pubsub_subscriptions", "standing subscriptions currently armed in the registry")
pubsub_match_batches = REGISTRY.counter(
    "geomesa_pubsub_match_batches_total",
    "acked append batches matched against the subscription layout "
    "(one fused join launch each, regardless of subscription count)")
pubsub_match_pairs = REGISTRY.counter(
    "geomesa_pubsub_match_pairs_total",
    "subscription×feature pairs that survived exact residual + visibility refinement")
pubsub_match_seconds = REGISTRY.histogram(
    "geomesa_pubsub_match_seconds", "fused batch×subscriptions match time per acked append batch")
pubsub_events_delivered = REGISTRY.counter(
    "geomesa_pubsub_events_delivered_total", "alert events written to connected push streams")
pubsub_deliver_bytes = REGISTRY.counter(
    "geomesa_pubsub_deliver_bytes_total", "push-stream body bytes written to subscribers")
pubsub_replay_records = REGISTRY.counter(
    "geomesa_pubsub_replay_records_total",
    "WAL records re-matched below a resuming subscriber's cursor")
pubsub_heartbeats = REGISTRY.counter(
    "geomesa_pubsub_heartbeats_total", "SSE :keepalive comments written to idle push streams")
pubsub_stream_overflows = REGISTRY.counter(
    "geomesa_pubsub_stream_overflows_total",
    "push streams torn down because their live event queue overflowed "
    "(the client resumes exactly-once from its cursor)")
pubsub_rearms = REGISTRY.counter(
    "geomesa_pubsub_rearms_total", "matcher re-arms from the replicated registry (promotion/recovery)")
