"""Streaming live layer: WAL-backed incremental ingest over the fs store.

Copy of ``geomesa_tpu/store/stream.py`` (ref role: the geomesa-kafka live
tier in front of the indexed store, rebuilt on LSM discipline). Streaming
writes go to

1. a checksummed, fsync-policied **write-ahead log**
   (:mod:`geomesa_tpu_torch.store.wal`), the ack point: a returned seq
   meets the ``store.fsync`` durability bar and survives a SIGKILL;
2. a bounded in-memory generation of **Z-sorted memtable runs** that
   serves at once: :meth:`StreamingStore.query` and ``count`` (and
   ``process.density`` / ``run_stats``, whose pushdown declines while runs
   are live, so they row-scan through ``query``) merge the runs' hits with
   the file-system store's partitions under one plan. Every scan is the
   runner's: one filter-scan mask launch (``csrc/filter_scan.cu``) for
   each surviving partition and for each run holding a surviving
   partition, on the wrapped store's device;
3. **generational compaction**: a daemon merges the sealed runs into the
   store's crash-consistent partition files with the WAL watermark in the
   same manifest publish, then truncates the consumed segments. It yields
   to serving load (:func:`resilience.brownout`) but never past the
   read-amplification bound: at ``wal.max.generations`` live runs, an
   append that needs a new run is shed (:class:`IngestBackpressureError`).

Recovery replays the WAL at open (torn tails truncated, records at or
below the manifest's ``wal_watermark`` skipped), so a SIGKILL anywhere in
append, rotate, compact or publish loses no acked row and invents none.
Queries snapshot the runs and read the store under one shared store-lock
section, and the compactor drops the runs it published inside the same
exclusive section, so a query never sees a row twice or not at all.

Delta listeners (``add_delta_listener``) receive each acked batch outside
the memtable lock: ``layer.add_delta_listener(lambda t, b:
index.refresh_delta(b))`` keeps a ``StreamingDeviceIndex`` staged from the
layer's merged view current without a restage. Seq listeners
(``add_seq_listener``) receive the batch with its WAL seq, the push tier's
delivery cursor (``pubsub/``), and retention floors
(``add_retention_floor``) hold the WAL segments a subscriber's cursor
still needs through a compaction.

Where the port differs: a WAL payload is the batch in the port's
columnar block format (``store/partfile.py``) behind a magic of its own,
not an Arrow IPC stream (the card's host has no ``pyarrow``); a payload
without that magic raises (ROADMAP section 3). The per-run scans defer
visibility by ``run_query``'s argument, never by a query hint. A stalled
compactor (shed appends and no publish for ``stream.stall.s``) writes an
``ingest-stall`` flight-recorder bundle; each compaction records a
``_system`` entry in the cost ledger. Left out, for the code that reads
it: the replication tier's follower side (``apply_replicated``,
``replica_positions``, ``install_snapshot``, ``ReplicationGapError`` and
the replicator's ``retention_floor``, ROADMAP item 7).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.index.build import build_index
from geomesa_tpu_torch.index.keyspaces import keyspace_for
from geomesa_tpu_torch.locking import checked_lock
from geomesa_tpu_torch.sched.scheduler import RejectedError
from geomesa_tpu_torch.spawn import spawn_thread
from geomesa_tpu_torch.store import partfile
from geomesa_tpu_torch.store.wal import WriteAheadLog

__all__ = ["IngestBackpressureError", "StreamingStore", "WalUnavailableError",
           "streaming_enabled"]

_log = logging.getLogger(__name__)
_retry_rng = random.Random()

#: leads every WAL payload the port writes: a batch in the partition-file
#: block format (``store/partfile.py``)
PAYLOAD_MAGIC = b"GMWALB\x00\x01"


def streaming_enabled() -> bool:
    """The ``stream.enabled`` switch the server reads when ``make_server``
    is given no ``stream`` argument."""
    from geomesa_tpu_torch.conf import sys_prop

    return bool(sys_prop("stream.enabled"))


class IngestBackpressureError(RejectedError):
    """The live layer is at its ``wal.max.generations`` bound: the caller
    backs off and retries (HTTP 429 with Retry-After: a RejectedError, so
    flow control applies unchanged and ``resilience.classify`` calls it
    FATAL, never retried or degraded away)."""

    def __init__(self, retry_after_s: float):
        RuntimeError.__init__(
            self,
            "streaming ingest backpressured: memtable at the wal.max.generations bound; "
            f"retry after {retry_after_s:g}s")
        self.retry_after_s = retry_after_s


class WalUnavailableError(RuntimeError):
    """The ``wal`` breaker is open: appends fail fast instead of queueing
    against a log that cannot take them."""


@dataclass
class _MemRun:
    """One Z-sorted in-memory run: a BuiltIndex and the highest WAL seq in
    it. ``sealed`` runs belong to a compaction in flight: appends stop
    coalescing into them."""

    built: object  # BuiltIndex
    max_seq: int
    primary: str
    sealed: bool = False

    @property
    def rows(self) -> int:
        return len(self.built.batch)


@dataclass
class _TypeStream:
    wal: WriteAheadLog
    #: orders appends (the WAL write and the memtable insert commit in seq
    #: order: a watermark over out-of-order runs would skip records at
    #: replay) and guards the runs list; the WAL write happens under it
    lock: object = None
    runs: "list[_MemRun]" = field(default_factory=list)
    appended_rows: int = 0
    compactions: int = 0
    last_publish: float = field(default_factory=time.monotonic)
    last_compact_s: float = 0.0
    kicked: bool = False  # an explicit compaction request (compact_now, close)


class StreamingStore:
    """Streaming facade over a :class:`FileSystemDataStore`: what it does
    not override delegates to the wrapped store, so a resident index and
    the processes treat it as a store whose queries include the live
    layer.

    >>> layer = StreamingStore(store)
    >>> layer.append("t", {...}, fids=[...])   # acked and queryable now
    >>> layer.query("t", "BBOX(geom, ...)")    # memtable and partitions
    """

    def __init__(self, store, scheduler=None):
        self.store = store
        self.scheduler = scheduler
        self._streams: "dict[str, _TypeStream]" = {}
        #: cb(type_name, batch) after each acked append
        self._listeners: list = []
        #: cb(type_name, batch, seq) after each acked append (the push tier)
        self._seq_listeners: list = []
        #: fn(type_name) -> int | None: WAL retention floors; a compaction
        #: truncates the WAL only up to the lowest of them
        self._retention_floors: list = []
        # the first touch of a type opens its WAL (segment scan, torn-tail
        # truncation) under this lock: two appenders racing the open would
        # append one segment through two fds
        self._streams_lock = checked_lock("store.stream.types", blocking_ok=True)
        self._cv = threading.Condition()
        self._stop = False
        self._recover_all()
        self._compactor = spawn_thread(self._compact_loop, name="stream-compactor", context=False)
        self._compactor.start()

    # -- delegation --------------------------------------------------------

    def __getattr__(self, name):
        return getattr(self.store, name)

    # -- per-type state ----------------------------------------------------

    def _wal_dir(self, type_name: str) -> str:
        return os.path.join(self.store.root, type_name, "_wal")

    def _ts(self, type_name: str) -> _TypeStream:
        ts = self._streams.get(type_name)
        if ts is not None:
            return ts
        if type_name not in self.store._types:
            raise KeyError(type_name)
        with self._streams_lock:
            ts = self._streams.get(type_name)
            if ts is None:
                ts = _TypeStream(wal=WriteAheadLog(self._wal_dir(type_name)),
                                 lock=checked_lock("store.stream.mem", blocking_ok=True))
                self._streams[type_name] = ts
        return ts

    # -- ingest ------------------------------------------------------------

    def append(self, type_name: str, columns_or_batch, fids=None) -> dict:
        """Durable streaming append: the WAL (the ack point), then the live
        memtable; returns ``{"seq", "rows"}``. The rows are queryable
        through this layer, and any index listening, before this returns;
        nothing is flushed or restaged here. Raises
        :class:`IngestBackpressureError` at the ``wal.max.generations``
        bound, before any byte reaches the WAL."""
        from geomesa_tpu_torch import ledger, metrics, resilience
        from geomesa_tpu_torch.conf import sys_prop
        from geomesa_tpu_torch.tracing import span

        st = self.store._types[type_name]
        if isinstance(columns_or_batch, FeatureBatch):
            batch = columns_or_batch
        else:
            batch = FeatureBatch.from_columns(st.sft, columns_or_batch, fids)
        if len(batch) == 0:
            return {"seq": -1, "rows": 0}
        ts = self._ts(type_name)
        max_gens = max(int(sys_prop("wal.max.generations")), 1)
        br = resilience.wal_breaker()
        with span("stream.append", type=type_name, rows=len(batch)):
            shed = None
            with ts.lock:
                if len(ts.runs) >= max_gens and not self._can_coalesce(type_name, ts, batch):
                    # at the bound and a new run would be needed: shed
                    # before any WAL byte lands, so nothing is acked; the
                    # stall bundle fires after the lock is released (its
                    # providers take it again)
                    metrics.stream_backpressure.inc()
                    shed = {"type": type_name, "runs": len(ts.runs),
                            "memtable_rows": sum(r.rows for r in ts.runs)}
                else:
                    if not br.allow():
                        raise WalUnavailableError(
                            "streaming ingest unavailable: the wal failure-domain breaker is open")
                    # the fallible work (sort, encode) before the WAL
                    # write: after the ack only infallible commits remain,
                    # or a record would replay rows its client saw fail
                    coalesce, built, primary = self._prepare_run_locked(type_name, ts, batch)
                    payload = self._encode(batch)
                    try:
                        seq = ts.wal.append(payload)
                    except Exception:
                        br.record_failure()
                        raise
                    br.record_success()
                    self._commit_run_locked(ts, built, coalesce, primary, seq)
                    ts.appended_rows += len(batch)
                    mem_rows = sum(r.rows for r in ts.runs)
                    nruns = len(ts.runs)
            if shed is not None:
                stalled = self._note_stall(ts, shed)
                self._kick()
                raise IngestBackpressureError(self._retry_after(ts, stalled))
            metrics.stream_appends.inc()
            metrics.stream_rows.inc(len(batch))
            metrics.stream_memtable_rows.set(mem_rows, type=type_name)
            metrics.stream_memtable_runs.set(nruns, type=type_name)
            ledger.charge("memtable_rows", len(batch))
            # the resident refresh outside the memtable lock: device
            # staging must not serialize WAL appends
            self._notify_delta(type_name, batch)
            self._notify_seq(type_name, batch, seq)
        if mem_rows >= int(sys_prop("stream.memtable.rows")):
            self._kick()
        return {"seq": int(seq), "rows": len(batch)}

    def _can_coalesce(self, type_name, ts, batch) -> bool:
        """Would this append fold into the tail run instead of opening a
        new one? (The caller holds ``ts.lock``.)"""
        from geomesa_tpu_torch.conf import sys_prop

        st = self.store._types[type_name]
        target = max(int(sys_prop("stream.run.rows")), 1)
        tail = ts.runs[-1] if ts.runs else None
        return (tail is not None and not tail.sealed and tail.primary == st.primary
                and tail.rows + len(batch) <= target)

    def _prepare_run_locked(self, type_name, ts, batch):
        """The fallible half of a memtable insert, before the WAL write
        (the caller holds ``ts.lock``): Z-sort the new run, or the tail run
        with the batch coalesced into it up to ``stream.run.rows``, which
        bounds both the re-sort per append and the run count. Returns
        ``(coalesce, BuiltIndex, primary)``."""
        st = self.store._types[type_name]
        ks = keyspace_for(st.sft, st.primary)
        if self._can_coalesce(type_name, ts, batch):
            merged = FeatureBatch.concat([ts.runs[-1].built.batch, batch])
            return True, build_index(ks, merged, self.store.partition_size), st.primary
        return False, build_index(ks, batch, self.store.partition_size), st.primary

    @staticmethod
    def _commit_run_locked(ts, built, coalesce, primary, seq) -> None:
        """The infallible half, after the ack point: list commits only."""
        run = _MemRun(built, max_seq=seq, primary=primary)
        if coalesce:
            ts.runs[-1] = run
        else:
            ts.runs.append(run)

    def _insert_locked(self, type_name, ts, batch, seq) -> None:
        """Prepare and commit in one step (replay: no WAL write races it)."""
        coalesce, built, primary = self._prepare_run_locked(type_name, ts, batch)
        self._commit_run_locked(ts, built, coalesce, primary, seq)

    # -- the WAL payload ---------------------------------------------------

    @staticmethod
    def _encode(batch: FeatureBatch) -> bytes:
        """A batch as a WAL payload: ``PAYLOAD_MAGIC`` and the batch as one
        partition-file block (the counterpart writes an Arrow IPC
        stream)."""
        data, _ = partfile.encode_rows(batch)
        return PAYLOAD_MAGIC + bytes(data)

    def _decode(self, type_name: str, payload: bytes) -> FeatureBatch:
        if bytes(payload[: len(PAYLOAD_MAGIC)]) != PAYLOAD_MAGIC:
            raise ValueError(
                f"dataset {type_name!r}: a WAL payload without the port's magic (an Arrow IPC "
                "record of the JAX package's live layer?) is not read: the port's WAL payloads "
                "are partition-file blocks (ROADMAP.md section 3, the WAL payload)")
        raw = partfile.parse_table(bytearray(payload[len(PAYLOAD_MAGIC):]))
        return partfile.decode_table(raw, self.store._types[type_name].sft)

    # -- backpressure ------------------------------------------------------

    def _retry_after(self, ts: _TypeStream, stalled: bool) -> float:
        """Retry-After from the measured compaction time: about one
        compaction, jittered so a shed fleet de-correlates, clamped to
        [0.1 s, 30 s]; a stalled compactor advertises the cap."""
        if stalled:
            return 30.0
        est = ts.last_compact_s or 1.0
        est *= 0.75 + 0.5 * _retry_rng.random()
        return min(max(est, 0.1), 30.0)

    @staticmethod
    def _note_stall(ts: _TypeStream, detail: dict) -> bool:
        """Shed appends with a compactor that has not published for
        ``stream.stall.s``: the stall verdict, with an ``ingest-stall``
        flight-recorder bundle (rate-limited by the recorder). Called with
        ``ts.lock`` released: the bundle's providers take it again."""
        from geomesa_tpu_torch.conf import sys_prop

        stall_s = float(sys_prop("stream.stall.s"))
        if stall_s <= 0:
            return False
        age = time.monotonic() - ts.last_publish
        if age < stall_s:
            return False
        try:
            from geomesa_tpu_torch import slo

            detail = dict(detail)
            detail["seconds_since_publish"] = round(age, 3)
            detail["wal"] = ts.wal.stats()
            slo.FLIGHTREC.trigger("ingest-stall", detail=detail)
        except Exception:  # the bundle is observability: the verdict stands
            pass
        return True

    # -- resident-index deltas ---------------------------------------------

    def add_delta_listener(self, cb) -> None:
        """``cb(type_name, batch)`` after every acked append, the resident
        index's incremental refresh. A listener's fault degrades (stamped
        ``ingest-degraded``): the rows are acked and served by the store
        path regardless."""
        self._listeners.append(cb)

    def remove_delta_listener(self, cb) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)

    def add_seq_listener(self, cb) -> None:
        """``cb(type_name, batch, seq)`` after every acked append: the seq is
        the continuous-query matcher's delivery cursor. A listener's fault
        degrades like a delta listener's (``ingest-degraded``): the rows are
        durable and queryable regardless, and subscribers recover the
        alerts through the cursor replay."""
        self._seq_listeners.append(cb)

    def remove_seq_listener(self, cb) -> None:
        if cb in self._seq_listeners:
            self._seq_listeners.remove(cb)

    def _notify_seq(self, type_name: str, batch, seq: int) -> None:
        from geomesa_tpu_torch import resilience

        for cb in list(self._seq_listeners):
            try:
                cb(type_name, batch, int(seq))
            except Exception as e:
                resilience.note_degraded("ingest-degraded")
                _log.warning("dataset %r: seq listener failed at seq %d (%s) -- subscribers "
                             "recover via cursor replay", type_name, seq, e)

    def add_retention_floor(self, fn) -> None:
        """Install a WAL retention floor (``fn(type_name) -> int | None``):
        a compaction truncates the WAL up to the lowest floor, never past
        its watermark."""
        self._retention_floors.append(fn)

    def remove_retention_floor(self, fn) -> None:
        if fn in self._retention_floors:
            self._retention_floors.remove(fn)

    def _retention_seq(self, type_name: str, watermark: int) -> int:
        """The WAL truncation bound of a compaction: its watermark, capped
        by every installed retention floor (a subscriber's cursor must
        outlive the compaction, or its resume answers 410). A failing floor
        is skipped: that only retains more."""
        bound = int(watermark)
        for fn in list(self._retention_floors):
            try:
                floor = fn(type_name)
            except Exception:  # a broken floor must not wedge compaction
                continue
            if floor is not None:
                bound = min(bound, int(floor))
        return bound

    def _notify_delta(self, type_name: str, batch) -> None:
        from geomesa_tpu_torch import resilience

        for cb in list(self._listeners):
            try:
                cb(type_name, batch)
            except Exception as e:
                resilience.note_degraded("ingest-degraded")
                _log.warning("dataset %r: resident delta refresh failed (%s) -- rows serve from "
                             "the store path until restage", type_name, e)

    # -- merged serving ----------------------------------------------------

    def _runs_snapshot(self, type_name: str) -> "list[_MemRun]":
        ts = self._streams.get(type_name)
        if ts is None:
            return []
        with ts.lock:
            return list(ts.runs)

    def _run_index(self, run: _MemRun, type_name: str):
        """The run's BuiltIndex, rebuilt only when the primary index changed
        under it, so the plan's ranges stay comparable."""
        st = self.store._types[type_name]
        if run.primary == st.primary:
            return run.built
        return build_index(keyspace_for(st.sft, st.primary), run.built.batch, self.store.partition_size)

    def _mem_chunks(self, type_name: str, runs, plan) -> list:
        """Per-run filtered batches: visibility and projection applied, no
        global sort or cap (the fs store's per-partition discipline)."""
        from geomesa_tpu_torch.device import resolve_device
        from geomesa_tpu_torch.query.plan import Query
        from geomesa_tpu_torch.query.runner import _post_process, run_query

        inner = dataclasses.replace(plan, query=Query(filter=plan.filter))
        outer = dataclasses.replace(
            plan, query=dataclasses.replace(plan.query, sort_by=None, max_features=None))
        device = resolve_device(self.store.device)
        out = []
        for run in runs:
            sub = run_query(self._run_index(run, type_name), inner, device, defer_visibility=True)
            if len(sub.batch):
                pp = _post_process(sub.batch, outer)
                if len(pp):
                    out.append(pp)
        return out

    def query(self, type_name: str, query=ast.Include):
        """Merged scan: the memtable runs and the partitions under one
        plan. The runs' snapshot and the store read share one shared
        store-lock section, so a query during a compaction sees every row
        once."""
        from geomesa_tpu_torch.query.plan import Query, as_query
        from geomesa_tpu_torch.query.runner import QueryResult, _post_process
        from geomesa_tpu_torch.tracing import span

        q = as_query(query)
        t0 = time.perf_counter()
        with span("stream.query", type=type_name) as sp:
            # flush outside the shared section (an exclusive upgrade under a
            # held shared flock would deadlock); streaming writes leave
            # nothing pending
            self.store.flush(type_name)
            with self.store._shared():
                runs = self._runs_snapshot(type_name)
                if not runs:
                    return self.store._query_locked(type_name, q, t0)
                # global sort and cap span both sources: strip them from the
                # store pass, apply them once after the merge
                base = self.store._query_locked(
                    type_name, dataclasses.replace(q, sort_by=None, max_features=None), t0)
            plan = base.plan
            chunks = self._mem_chunks(type_name, runs, plan)
            mem_rows = sum(r.rows for r in runs)
            sp.set(runs=len(runs), mem_rows=mem_rows)
            merged = base.batch
            if chunks:
                parts = ([base.batch] if len(base.batch) else []) + chunks
                merged = parts[0] if len(parts) == 1 else FeatureBatch.concat(parts)
            if q.sort_by or q.max_features is not None:
                final_q = Query(filter=ast.Include, sort_by=q.sort_by, sort_desc=q.sort_desc,
                                max_features=q.max_features)
                # visibility and projection were applied per source
                merged = _post_process(merged, dataclasses.replace(plan, query=final_q),
                                       defer_visibility=True)
            return QueryResult(merged, plan, base.scanned + mem_rows, base.total + mem_rows)

    def count(self, type_name: str, query=ast.Include) -> int:
        """Merged count: the store keeps its chunk-pushdown path; the runs'
        hits under the same plan add on top."""
        from geomesa_tpu_torch.query.plan import as_query

        q = as_query(query)
        if q.max_features is not None or q.sort_by:
            return len(self.query(type_name, q))
        self.store.flush(type_name)  # outside the lock, as in query()
        with self.store._shared():
            runs = self._runs_snapshot(type_name)
            if not runs:
                return self.store.count(type_name, q)
            self.store._refresh_from_disk(type_name)
            plan = self.store._plan_locked(type_name, q)
            base = self.store.count(type_name, q)
        return base + sum(len(c) for c in self._mem_chunks(type_name, runs, plan))

    def density_pushdown(self, type_name, query, envelope, width, height):
        """Chunk pre-aggregates cannot see the memtable: with live runs the
        pushdown declines (None) and the caller row-scans through
        :meth:`query`, which merges."""
        if self._runs_snapshot(type_name):
            return None
        return self.store.density_pushdown(type_name, query, envelope, width, height)

    def stats_pushdown(self, type_name, query, stat_spec):
        if self._runs_snapshot(type_name):
            return None
        return self.store.stats_pushdown(type_name, query, stat_spec)

    def has_chunk_stats(self, type_name: str) -> bool:
        """False while live runs exist: the brownout rung must not promise
        a pre-aggregated answer that misses the memtable."""
        if self._runs_snapshot(type_name):
            return False
        return self.store.has_chunk_stats(type_name)

    def manifest_rows(self, type_name: str) -> int:
        return self.store.manifest_rows(type_name) + sum(
            r.rows for r in self._runs_snapshot(type_name))

    # -- compaction --------------------------------------------------------

    def _kick(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def compact_now(self, type_name: "str | None" = None) -> None:
        """Synchronous compaction: merge every live run of ``type_name``
        (or of every type) into the partition files."""
        for t in [type_name] if type_name else list(self._streams):
            ts = self._streams.get(t)
            if ts is None:
                continue
            ts.kicked = True
            self._compact_type(t, ts)

    def _compact_due(self, ts: _TypeStream) -> bool:
        from geomesa_tpu_torch.conf import sys_prop

        if ts.kicked:
            return True
        with ts.lock:
            rows = sum(r.rows for r in ts.runs)
            nruns = len(ts.runs)
        return rows >= int(sys_prop("stream.memtable.rows")) or \
            nruns >= max(int(sys_prop("wal.max.generations")), 1)

    def _at_bound(self, ts: _TypeStream) -> bool:
        from geomesa_tpu_torch.conf import sys_prop

        with ts.lock:
            return len(ts.runs) >= max(int(sys_prop("wal.max.generations")), 1)

    def _yield_to_serving(self, ts: _TypeStream) -> None:
        """Brownout discipline: while the scheduler's queue is past the
        brownout fraction and appends are not yet shed at the bound, the
        compactor pauses in ``stream.compact.yield.ms`` steps, for at most
        half of ``stream.stall.s``, so a saturated queue never starves
        compaction into an ingest stall."""
        from geomesa_tpu_torch import metrics, resilience
        from geomesa_tpu_torch.conf import sys_prop

        step = max(float(sys_prop("stream.compact.yield.ms")), 1.0) / 1e3
        budget = max(float(sys_prop("stream.stall.s")) / 2.0, step)
        spent = 0.0
        while (spent < budget and not self._stop and not ts.kicked and not self._at_bound(ts)
               and resilience.brownout(self.scheduler)):
            metrics.stream_compact_yields.inc()
            time.sleep(step)
            spent += step

    def _compact_loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                self._cv.wait(timeout=0.25)
                if self._stop:
                    return
            for t in list(self._streams):
                ts = self._streams.get(t)
                if ts is None or not self._compact_due(ts):
                    continue
                self._yield_to_serving(ts)
                try:
                    self._compact_type(t, ts)
                except Exception as e:
                    _log.warning("dataset %r: background compaction failed (%s: %s); acked rows "
                                 "remain WAL-durable and memtable-served; will retry",
                                 t, type(e).__name__, e)
                    time.sleep(0.2)  # no hot loop against a broken disk

    def _compact_type(self, type_name: str, ts: _TypeStream) -> None:
        """One generational compaction: seal and merge the live runs, flush
        them through the store's crash-consistent rewrite with the WAL
        watermark in the same manifest publish, drop the sealed runs in the
        same exclusive section, then truncate the consumed WAL segments. A
        crash before the publish replays everything; after it, the
        watermark makes replay skip the compacted records."""
        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.failpoints import fail_point
        from geomesa_tpu_torch.tracing import span

        t0 = time.perf_counter()
        ts.kicked = False
        with span("stream.compact", type=type_name) as sp, self.store._exclusive():
            self.store._refresh_from_disk(type_name)
            st = self.store._types[type_name]
            with ts.lock:
                runs = list(ts.runs)
                for r in runs:
                    r.sealed = True  # appends stop coalescing into these
            if not runs:
                return
            watermark = max(r.max_seq for r in runs)
            merged = runs[0].built.batch if len(runs) == 1 else FeatureBatch.concat(
                [r.built.batch for r in runs])
            sp.set(runs=len(runs), rows=len(merged))
            prev_wm = st.wal_watermark
            st.pending.append(merged)
            st.wal_watermark = max(prev_wm, watermark)
            try:
                self.store._flush_locked(type_name)
            except BaseException:
                # a failure before the publish restored pending (our batch
                # among it) for a retry, but the runs stay the live copy and
                # the WAL the durable one: roll both back, or the next flush
                # doubles every row. After the publish the manifest owns the
                # rows and pending was not restored (our batch is absent):
                # drop the runs as on success.
                if any(b is merged for b in st.pending):
                    st.pending = [b for b in st.pending if b is not merged]
                    st.wal_watermark = prev_wm
                    with ts.lock:
                        # re-open the runs to tail coalescing, or one
                        # transient error would pin every later append into
                        # a run of its own and race the bound
                        for r in runs:
                            r.sealed = False
                    raise
            with ts.lock:
                sealed = {id(r) for r in runs}
                ts.runs = [r for r in ts.runs if id(r) not in sealed]
                mem_rows = sum(r.rows for r in ts.runs)
                nruns = len(ts.runs)
        metrics.stream_memtable_rows.set(mem_rows, type=type_name)
        metrics.stream_memtable_runs.set(nruns, type=type_name)
        fail_point("fail.compact.publish")
        ts.wal.truncate_through(self._retention_seq(type_name, watermark))
        dur = time.perf_counter() - t0
        ts.compactions += 1
        ts.last_publish = time.monotonic()
        ts.last_compact_s = dur
        metrics.stream_compactions.inc()
        metrics.stream_compact_seconds.observe(dur)
        from geomesa_tpu_torch import ledger

        if ledger.enabled():
            # background work lands on /stats/ledger under the _system
            # tenant, never in the SLO engine (a compaction is not a
            # serving-latency sample)
            cost = ledger.RequestCost(tenant="_system", endpoint="other", lane="batch",
                                      shape="compact")
            cost.status = 200
            cost.dur_s = dur
            cost.charge("compact_seconds", dur)
            ledger.LEDGER.record(cost)

    # -- recovery ----------------------------------------------------------

    def _recover_all(self) -> None:
        for type_name in self.store.type_names:
            if os.path.isdir(self._wal_dir(type_name)):
                self._recover_type(type_name)

    def _recover_type(self, type_name: str) -> None:
        """Replay the WAL into memtable runs at open: records at or below
        the manifest watermark are in the partition files already (skipped),
        torn tails were truncated by the segment scan (stamped
        ``wal-replay-truncated``), and fully compacted segments go."""
        from geomesa_tpu_torch import metrics, resilience

        ts = self._ts(type_name)  # opening the WAL truncates torn tails
        st = self.store._types[type_name]
        watermark = int(st.wal_watermark)
        replayed = 0
        with ts.lock:
            for seq, payload in ts.wal.replay(after_seq=watermark):
                batch = self._decode(type_name, payload)
                if len(batch):
                    self._insert_locked(type_name, ts, batch, seq)
                    replayed += len(batch)
            ts.appended_rows += replayed
            mem_rows = sum(r.rows for r in ts.runs)
            nruns = len(ts.runs)
        if ts.wal.truncations:
            resilience.note_degraded("wal-replay-truncated")
        if replayed:
            metrics.stream_wal_replay_rows.inc(replayed)
            metrics.stream_memtable_rows.set(mem_rows, type=type_name)
            metrics.stream_memtable_runs.set(nruns, type=type_name)
            _log.info("dataset %r: WAL replay recovered %d acked row(s) into %d memtable run(s)",
                      type_name, replayed, nruns)
        ts.wal.truncate_through(watermark)

    # -- introspection / lifecycle -----------------------------------------

    def stream_stats(self) -> dict:
        """The ``/stats/stream`` document."""
        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.conf import sys_prop

        types = {}
        for t, ts in list(self._streams.items()):
            with ts.lock:
                runs = [{"rows": r.rows, "max_seq": r.max_seq, "sealed": r.sealed} for r in ts.runs]
            st = self.store._types.get(t)
            types[t] = {
                "memtable_rows": int(sum(r["rows"] for r in runs)),
                "runs": runs,
                "wal_watermark": int(st.wal_watermark) if st else -1,
                "appended_rows": ts.appended_rows,
                "compactions": ts.compactions,
                "last_compact_seconds": round(ts.last_compact_s, 4),
                "seconds_since_publish": round(time.monotonic() - ts.last_publish, 3),
                "wal": ts.wal.stats(),
            }
        return {
            "enabled": True,
            "max_generations": int(sys_prop("wal.max.generations")),
            "types": types,
            "counters": {
                "appends": metrics.stream_appends.value(),
                "rows": metrics.stream_rows.value(),
                "wal_bytes": metrics.stream_wal_bytes.value(),
                "wal_fsyncs": metrics.stream_wal_fsyncs.value(),
                "backpressure": metrics.stream_backpressure.value(),
                "compactions": metrics.stream_compactions.value(),
                "replay_rows": metrics.stream_wal_replay_rows.value(),
                "replay_truncations": metrics.stream_wal_truncations.value(),
            },
        }

    def close(self, compact: bool = False) -> None:
        """Stop the compactor and close the WAL segments. Acked rows not
        yet compacted stay durable in the WAL and replay at the next open;
        ``compact=True`` folds them into the partition files first (a
        drain, not a safety requirement)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._compactor.join(timeout=10.0)
        if compact:
            for t in list(self._streams):
                if self._runs_snapshot(t):
                    try:
                        self._compact_type(t, self._streams[t])
                    except Exception:  # the rows stay WAL-durable and replay on reopen
                        pass
        for ts in self._streams.values():
            ts.wal.close()
