"""Metrics registry of the port's serving path.

Counterpart of ``geomesa_tpu/metrics.py``, trimmed to the core (Counter,
Gauge, Histogram with labels, one process-global registry) and the
metrics the device query scheduler and its watchdog write: queue depth,
wait time, queries, launches, fused queries, rejections, expirations,
worker failures, drains and watchdog timeouts; the streaming index's
delta refreshes by mode; the spatial join engine's counters and
histograms and the device BIN pack's launches (reference lines 644-697);
the store path's queries, query latency and OOM recoveries; the
file-system store's host I/O (``io_*``), generations, recovery sweeps,
checksums and quarantines (``store_*``) and its aggregation pushdown
(``agg_pushdown_*``, reference lines 280-380); the serving retries
(``resilience_retries``) and the streaming live layer's appends, WAL,
replay, memtable, backpressure and compaction (``stream_*``, reference
lines 547-596). The Prometheus exposition
and every other family of the counterpart are left out.
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

    @staticmethod
    def labels(**labels) -> tuple:
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
    (the last slot is +Inf), the sum and the number of observations."""

    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))

    def observe(self, v: float, **labels) -> None:
        key = self.labels(**labels)
        with self._lock:
            st = self._values.setdefault(
                key, {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "n": 0})
            st["counts"][bisect_left(self.buckets, v)] += 1
            st["sum"] += v
            st["n"] += 1

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
