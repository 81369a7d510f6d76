"""Pipelined host I/O: bounded read-ahead over partition files.

Copy of ``geomesa_tpu/store/prefetch.py`` (ref role: Accumulo tablet
servers stream ranges to a scan in parallel, the BatchScanner's read-ahead
threads). ``prefetch_map(fn, items)`` runs ``fn`` on worker threads with
a bounded number of items in flight and yields the results IN INPUT
ORDER, so the file read and decode of partition i+k overlap what the
consumer does with partition i (its filter-scan launch on the card). The
heavy per-item work (file reads, ``zlib.crc32``, numpy copies) releases
the GIL.

Memory bound: at most ``depth`` results exist at once, and completed
results waiting in the queue respect ``byte_budget`` (topping up stops
while they exceed it), so peak host memory is roughly ``byte_budget`` +
``workers`` x one item. Ordered delivery means a slow head item
back-pressures the pipeline rather than reordering results.

Failure discipline: an ``fn`` exception surfaces to the consumer at that
item's position; the executor is then drained and shut down (queued
items cancelled, running ones finish and are discarded), so an error
mid-stream neither deadlocks the queue nor leaks threads. Closing the
generator early (a query deadline) runs the same cleanup. Transient read
errors (OSError, the ``fail.read.io`` failpoint) are retried on the
worker with bounded, jittered exponential backoff before surfacing
(``io.retries`` x ``io.backoff.ms``, capped by ``io.backoff.cap.ms``);
FileNotFoundError and domain failures (a checksum quarantine) stay
immediate.

Knobs resolve from the ``io.*`` system properties when no explicit
:class:`PrefetchConfig` is given; ``workers=0`` disables the threads (the
serial baseline).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from geomesa_tpu_torch.locking import checked_lock

__all__ = ["PrefetchConfig", "prefetch_map", "batch_nbytes"]

#: thread-name prefix for every prefetch worker (tests assert cleanup)
WORKER_PREFIX = "geomesa-io"


@dataclass(frozen=True)
class PrefetchConfig:
    """Host-I/O pipeline knobs.

    ``workers`` is the decode thread count (0 = serial, no threads);
    ``depth`` bounds items in flight (submitted but not yet consumed;
    0 = auto, ``2 * workers``); ``byte_budget`` bounds the bytes of
    COMPLETED results waiting for the consumer (0 = unbounded) — the
    queue-occupancy half of the memory bound documented above."""

    workers: int = 4
    depth: int = 0
    byte_budget: int = 256 << 20

    @property
    def effective_depth(self) -> int:
        return self.depth if self.depth > 0 else max(2 * self.workers, 2)

    @staticmethod
    def from_props() -> "PrefetchConfig":
        from geomesa_tpu_torch.conf import sys_prop

        return PrefetchConfig(
            workers=int(sys_prop("io.workers")),
            depth=int(sys_prop("io.readahead")),
            byte_budget=int(sys_prop("io.queue.bytes")),
        )

    @staticmethod
    def coerce(io) -> "PrefetchConfig":
        """None -> the ``io.*`` system properties (resolved NOW, so a
        test's ``prop_override`` takes effect per call); an int -> that
        worker count with defaults; a config passes through."""
        if io is None:
            return PrefetchConfig.from_props()
        if isinstance(io, PrefetchConfig):
            return io
        if isinstance(io, int):
            return PrefetchConfig(workers=io)
        raise TypeError(
            f"io must be a PrefetchConfig, int worker count or None, "
            f"not {type(io).__name__}"
        )


def batch_nbytes(batch) -> int:
    """Rough host bytes of a FeatureBatch (numpy columns only; object
    columns count pointer width — good enough for a queue budget)."""
    try:
        return int(
            sum(int(v.nbytes) for v in batch.columns.values())
            + int(batch.fids.nbytes)
        )
    except Exception:  # a sizing heuristic: an unsizable batch counts 0
        return 0


def _with_retries(fn):
    """Transient-read resilience for the pipeline workers: retry ``fn``
    on OSError with bounded, JITTERED exponential backoff —
    ``io.retries`` extra attempts, ``io.backoff.ms`` base doubling per
    attempt scaled 0.5-1.5x (a fleet of workers hitting the same
    flapping disk de-correlates), the CUMULATIVE sleep capped by
    ``io.backoff.cap.ms`` so a flapping disk can never stall a worker
    for unbounded wall-clock (once the budget is spent the next error
    surfaces immediately). Reads are idempotent, so re-running the
    whole work item is safe. NOT retried: FileNotFoundError (a real
    state — e.g. another writer GC'd the generation mid-scan, which a
    refresh must resolve, not a sleep) and non-OSError domain failures
    (checksum quarantines stay loud)."""
    from geomesa_tpu_torch.conf import sys_prop

    retries = int(sys_prop("io.retries"))
    if retries <= 0:
        return fn

    def call(item):
        import time as _time

        from geomesa_tpu_torch import metrics
        from geomesa_tpu_torch.resilience import backoff_sleeps

        # per-item budget, resolved per call so prop_override applies
        sleeps = backoff_sleeps(
            retries,
            float(sys_prop("io.backoff.ms")),
            float(sys_prop("io.backoff.cap.ms")),
        )
        while True:
            try:
                return fn(item)
            except FileNotFoundError:
                raise
            except OSError:
                delay = next(sleeps, None)
                if delay is None:
                    raise  # retries/budget exhausted: surface the error
                metrics.store_read_retries.inc()
                _time.sleep(delay)

    return call


def prefetch_map(fn, items, config=None, size_of=None):
    """Ordered pipelined map: ``fn(item)`` runs on worker threads with
    bounded read-ahead; results yield in input order (see the module
    docstring for the memory bound and failure discipline). Transient
    OSErrors from ``fn`` are retried per the ``io.retries`` /
    ``io.backoff.ms`` properties (see :func:`_with_retries`).

    ``items`` is only ever advanced on the consumer thread, so plain
    generators are fine as input. ``size_of(result)`` opts results into
    the byte budget. With ``workers <= 0`` this is exactly
    ``map(fn, items)`` — no threads, the serial baseline (retries still
    apply)."""
    cfg = PrefetchConfig.coerce(config)
    fn = _with_retries(fn)
    if cfg.workers <= 0:
        for item in items:
            yield fn(item)
        return
    yield from _prefetch_threads(fn, items, cfg, size_of)


def _prefetch_threads(fn, items, cfg: PrefetchConfig, size_of):
    from geomesa_tpu_torch import metrics
    from geomesa_tpu_torch.spawn import ContextPool

    it = iter(items)
    depth = cfg.effective_depth
    budget = cfg.byte_budget
    lock = checked_lock("prefetch.queued")
    queued = {"bytes": 0}  # completed-but-unconsumed result bytes

    def run(item):
        # the request's contexts (trace spans, cost collector,
        # degradation) cross to the worker through ContextPool: without
        # them bytes read on a worker would charge nobody
        out = fn(item)
        b = 0
        if size_of is not None and budget:
            try:
                b = int(size_of(out))
            except Exception:  # a sizing heuristic: the item goes uncounted
                b = 0
            with lock:
                queued["bytes"] += b
            if b:
                metrics.io_queue_bytes.inc(b)
        return out, b

    pending: deque = deque()
    ex = ContextPool(cfg.workers, thread_name_prefix=WORKER_PREFIX)
    # gauges are updated by DELTA (inc/dec), never set: several
    # pipelines commonly run at once (concurrent queries on a threaded
    # server) and each must contribute only its own share
    try:
        exhausted = False
        while True:
            while not exhausted and len(pending) < depth:
                if budget and pending and queued["bytes"] >= budget:
                    # queue over budget: stop topping up, but always keep
                    # >= 1 item in flight so the pipeline cannot stall
                    break
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(ex.submit(run, item))
                metrics.io_prefetch_depth.inc()
            if not pending:
                break
            # resolve BEFORE popping: if fn raised, the future stays in
            # `pending` so the finally's gauge retraction still counts it
            out, b = pending[0].result()
            pending.popleft()
            metrics.io_prefetch_depth.dec()
            if b:
                with lock:
                    queued["bytes"] -= b
                metrics.io_queue_bytes.dec(b)
            metrics.io_chunks.inc()
            yield out
    finally:
        # error or early close: cancel what never started, let running
        # items finish (fn may hold external resources mid-call), and
        # join the workers — nothing leaks past this frame
        for f in pending:
            f.cancel()
        ex.shutdown(wait=True, cancel_futures=True)
        # after the join, retract this pipeline's leftover contribution
        # (unconsumed completed items and their accounted bytes)
        metrics.io_prefetch_depth.dec(len(pending))
        metrics.io_queue_bytes.dec(queued["bytes"])
        queued["bytes"] = 0
