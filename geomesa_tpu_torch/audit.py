"""Query audit log (ref: geomesa-index-api's AuditWriter and AuditedEvent).

Copy of ``geomesa_tpu/audit.py`` trimmed to what the stores call:
``AuditedEvent``, the asynchronous ``AuditWriter`` (a daemon thread
draining a queue), ``MemoryAuditWriter``, the JSON-lines
``FileAuditWriter`` of the file-system store (``audit=True`` writes
``<root>/_queries.jsonl``) and ``observe_query``.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import threading
import time
from dataclasses import asdict, dataclass, field

from geomesa_tpu_torch.spawn import spawn_thread


@dataclass
class AuditedEvent:
    store: str
    type_name: str
    filter: str
    user: str = ""
    planning_ms: float = 0.0
    scanning_ms: float = 0.0
    hits: int = 0
    trace_id: str = ""  # the request's trace, when one is open
    outcome: str = "ok"
    # comma-joined degradation reasons noted during the request; "" =
    # full fidelity
    degraded: str = ""
    ts: float = field(default_factory=time.time)  # epoch seconds, by design

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)


class AuditWriter:
    """Async audit sink. Subclasses implement _write(event).

    The drain thread is a daemon (it must never keep a process alive), so
    :meth:`close` drains and stops it; it is registered with ``atexit``
    when the thread first starts."""

    _STOP = object()  # drain-thread shutdown sentinel

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = spawn_thread(self._drain, name="audit-drain", context=False)
        self._started = False
        self._closed = False
        self._lock = threading.Lock()

    def write(self, event: AuditedEvent) -> None:
        with self._lock:
            if not self._closed:
                if not self._started:
                    self._thread.start()
                    self._started = True
                    atexit.register(self.close)
                # enqueue under the lock: a put after close() drained the
                # queue would be lost
                self._q.put(event)
                return
        # after close: write synchronously, outside the state lock
        try:
            self._write(event)
        except Exception:
            pass

    def flush(self, timeout: float = 5.0) -> None:
        if self._started:
            # unfinished_tasks, not empty(): the drain thread removes an
            # event from the queue before _write completes
            deadline = time.monotonic() + timeout
            while self._q.unfinished_tasks and time.monotonic() < deadline:
                time.sleep(0.005)

    def close(self, timeout: float = 5.0) -> None:
        """Drain every queued event and stop the writer thread. Safe to
        call repeatedly; later writes are synchronous."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if not started:
            return
        self.flush(timeout)
        self._q.put(self._STOP)
        self._thread.join(timeout=timeout)

    def _drain(self) -> None:
        while True:
            ev = self._q.get()
            try:
                if ev is self._STOP:
                    return
                self._write(ev)
            except Exception:
                pass  # audit must never take down the query path
            finally:
                self._q.task_done()

    def _write(self, event: AuditedEvent) -> None:  # pragma: no cover
        raise NotImplementedError


class MemoryAuditWriter(AuditWriter):
    def __init__(self):
        super().__init__()
        self.events: list = []

    def _write(self, event: AuditedEvent) -> None:
        self.events.append(event)


class FileAuditWriter(AuditWriter):
    """JSONL audit file -- the ``<catalog>_queries`` table analog."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        # serializes appends: one un-torn line per event
        self._flock = threading.Lock()

    def _write(self, event: AuditedEvent) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with self._flock, open(self.path, "a") as fh:
            fh.write(event.to_json() + "\n")

    def read_events(self) -> list:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as fh:
            return [AuditedEvent(**json.loads(line)) for line in fh if line.strip()]


def observe_query(store, type_name, plan, t0, t1, t2, result, audit_writer):
    """Bump the query metrics and emit the audit event; never throws into
    the query path."""
    try:
        from geomesa_tpu_torch import resilience
        from geomesa_tpu_torch.metrics import queries_run, query_seconds
        from geomesa_tpu_torch.tracing import current_span

        queries_run.inc(store=store, type=type_name)
        query_seconds.observe(t2 - t0)
        if audit_writer is not None:
            sp = current_span()
            audit_writer.write(
                AuditedEvent(
                    store=store,
                    type_name=type_name,
                    filter=str(plan.query.filter),
                    planning_ms=(t1 - t0) * 1e3,
                    scanning_ms=(t2 - t1) * 1e3,
                    hits=len(result),
                    trace_id=sp.trace.trace_id if sp is not None else "",
                    degraded=",".join(resilience.capture_degraded() or ()),
                )
            )
    except Exception:  # pragma: no cover - observability must not break reads
        pass
