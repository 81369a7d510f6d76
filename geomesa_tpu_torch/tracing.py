"""End-to-end query tracing: per-request span trees across the serving
path.

Counterpart of ``geomesa_tpu/tracing.py``. A :class:`Trace` is one
request: a trace id, a root :class:`Span` and a tree of timed child spans
(name, attrs, start offset, duration, thread). Spans nest through a
contextvar: ``with span("query.plan"):`` attaches to whatever span is
current on this thread.

The process-wide :class:`Tracer` (module global ``TRACER``) keeps a
bounded ring of recent finished traces and decides retention:
head-sampling (``trace.sample``, the probability a trace is kept) or
always-on slow capture (wall time >= ``trace.slow_ms``). Slow traces also
append to the slow-query log (``_slow_queries.jsonl`` beside the store's
audit log, full trace embedded). ``trace.sample=0`` with
``trace.slow_ms=0`` turns recording off: spans become no-ops and only
the trace id remains (requests still get their ``X-Request-Id`` echo).

Context crosses thread pools explicitly: contextvars are per thread, so
the submitting thread calls :func:`capture` and the worker runs ``with
attach(ctx):``. Spans timed elsewhere (the scheduler's queue wait, a
shared fused launch fanned out to every rider) attach afterwards with
:func:`record_span`.

Export: ``Trace.to_dict()`` is the ``/debug/traces/<id>`` JSON;
``Trace.to_perfetto()`` is Chrome-trace/Perfetto JSON. :func:`format_trace`
(the pretty span tree) and :func:`coverage` (the share of the request's
wall time its spans explain) serve the CLI's ``trace`` command (reference
lines 451 and 502).
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager

from geomesa_tpu_torch.locking import checked_lock

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "TRACER",
    "span",
    "record_span",
    "capture",
    "attach",
    "current_span",
    "current_trace",
    "current_trace_id",
    "format_trace",
    "coverage",
]

_current: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_tpu_torch_span", default=None
)


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _clean_id(trace_id) -> "str | None":
    """Sanitize an inbound (client-supplied) trace id: printable, short,
    no characters that could corrupt a JSONL log line or a URL path."""
    if not trace_id:
        return None
    s = "".join(
        c for c in str(trace_id)[:64] if c.isalnum() or c in "-_.:"
    )
    return s or None


class Span:
    """One timed operation in a trace. ``set(**attrs)`` adds attributes
    after creation (e.g. a row count known only at the end)."""

    __slots__ = (
        "name", "attrs", "start_s", "dur_s", "children", "thread", "trace"
    )

    def __init__(self, name: str, trace: "Trace", start_s: float, attrs):
        self.name = name
        self.trace = trace
        self.start_s = start_s  # relative to the trace's t0
        self.dur_s: "float | None" = None
        self.attrs = dict(attrs) if attrs else {}
        self.children: list = []
        self.thread = threading.current_thread().name

    def set(self, **attrs) -> None:
        # copy-on-write reference swap, never in-place mutation: a
        # serializer (slow-log write, /debug/traces read) may be
        # iterating the attrs dict from another thread while a late
        # prefetch worker is still stamping attributes on this span
        new = dict(self.attrs)
        new.update(attrs)
        self.attrs = new

    def to_dict(self) -> dict:
        # snapshot under the trace lock: begin_span appends children
        # concurrently (workers can outlive the root by a beat)
        with self.trace.lock:
            children = list(self.children)
        return {
            "name": self.name,
            "start_ms": round(self.start_s * 1e3, 3),
            "dur_ms": (
                round(self.dur_s * 1e3, 3) if self.dur_s is not None else None
            ),
            "thread": self.thread,
            "attrs": self.attrs,
            "children": [c.to_dict() for c in children],
        }


class _NoopSpan:
    """Inert span: recording off / no active trace. ``set`` swallows."""

    __slots__ = ()
    trace = None

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class Trace:
    """One request's span tree. Created by :meth:`Tracer.trace`; child
    spans attach via :func:`span` / :func:`record_span`. ``recording``
    False means head-sampling declined AND slow capture is off — the
    trace exists only to carry its id."""

    def __init__(
        self, tracer: "Tracer", name: str, trace_id: str,
        sampled: bool, slow_ms: float, recording: bool,
    ):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.sampled = sampled
        self.slow_ms = slow_ms
        self.recording = recording
        # epoch anchor for summaries + Perfetto timestamps (wall-clock by
        # design; every duration below uses perf_counter)
        self.t0_epoch = time.time()
        self.t0 = time.perf_counter()
        self.dur_s: "float | None" = None
        self.slow = False
        self.lock = checked_lock("tracing.trace")
        self.root = (
            Span(name, self, 0.0, None) if recording else _NOOP
        )

    # -- span plumbing (called by the module-level helpers) ----------------

    def begin_span(self, name: str, parent: Span, attrs) -> Span:
        sp = Span(name, self, time.perf_counter() - self.t0, attrs)
        with self.lock:
            parent.children.append(sp)
        return sp

    def add_finished(
        self, name: str, parent: Span, start_perf: float, dur_s: float, attrs
    ) -> Span:
        """A retroactive span: timed elsewhere (queue wait, a shared
        fused launch), attached once its duration is known."""
        sp = Span(name, self, start_perf - self.t0, attrs)
        sp.dur_s = dur_s
        with self.lock:
            parent.children.append(sp)
        return sp

    def finish(self) -> None:
        self.dur_s = time.perf_counter() - self.t0
        if self.recording:
            self.root.dur_s = self.dur_s
        self.slow = self.slow_ms > 0 and self.dur_s * 1e3 >= self.slow_ms
        self.tracer._finish(self)

    # -- export -------------------------------------------------------------

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "ts": round(self.t0_epoch, 3),
            "duration_ms": (
                round(self.dur_s * 1e3, 3) if self.dur_s is not None else None
            ),
            "sampled": self.sampled,
            "slow": self.slow,
        }

    def to_dict(self) -> dict:
        doc = self.summary()
        doc["spans"] = (
            self.root.to_dict() if isinstance(self.root, Span) else None
        )
        return doc

    def to_perfetto(self) -> dict:
        """Chrome-trace (Perfetto-loadable) JSON: one complete ("X")
        event per span, microsecond timestamps anchored at the trace's
        epoch start, tids mapped from python thread names."""
        events: list = []
        tids: dict = {}

        def tid_of(thread: str) -> int:
            if thread not in tids:
                tids[thread] = len(tids) + 1
                events.append({
                    "name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tids[thread], "args": {"name": thread},
                })
            return tids[thread]

        def walk(sp: Span) -> None:
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": round((self.t0_epoch + sp.start_s) * 1e6, 1),
                "dur": round((sp.dur_s or 0.0) * 1e6, 1),
                "pid": 1,
                "tid": tid_of(sp.thread),
                "cat": "geomesa",
                "args": dict(sp.attrs),
            })
            with self.lock:  # same late-append race as Span.to_dict
                kids = list(sp.children)
            for c in kids:
                walk(c)

        if isinstance(self.root, Span):
            walk(self.root)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id, "name": self.name},
        }


class Tracer:
    """Process-wide trace registry: starts traces (sampling decision),
    keeps a bounded ring of recent finished ones, writes the slow-query
    log. The module global :data:`TRACER` is the one the serving path
    uses; tests may build their own."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._lock = checked_lock("tracing.ring")
        self._ring: OrderedDict = OrderedDict()  # trace_id -> Trace
        #: slow-query JSONL path; None = no slow log (set by make_server
        #: next to the store's audit log)
        self.slow_log_path: "str | None" = None
        # serializes slow-log appends; holding across the write is the
        # lock's whole purpose (one JSONL line per trace, never torn)
        self._log_lock = checked_lock("tracing.slowlog", blocking_ok=True)

    @contextmanager
    def trace(self, name: str, trace_id=None, attrs=None):
        """Open a root span for one request. Yields the :class:`Trace`
        (never None — even unrecorded traces carry an id for the
        ``X-Request-Id`` echo); on exit the trace finishes and retention
        is decided (ring buffer if sampled or slow; slow log if slow)."""
        from geomesa_tpu_torch.conf import sys_prop

        try:
            sample = float(sys_prop("trace.sample"))
            slow_ms = float(sys_prop("trace.slow_ms"))
        except Exception:
            # a malformed GEOMESA_TPU_TRACE_* env value must degrade
            # tracing, never drop the request it wraps — fall back to
            # slow-capture-only (the always-on safety net)
            sample, slow_ms = 0.0, 500.0
        sampled = sample > 0 and random.random() < sample
        recording = sampled or slow_ms > 0
        t = Trace(
            self, name, _clean_id(trace_id) or _new_trace_id(),
            sampled, slow_ms, recording,
        )
        if attrs and recording:
            t.root.set(**attrs)
        token = _current.set(t.root if recording else _NOOP)
        try:
            yield t
        finally:
            _current.reset(token)
            t.finish()

    def _finish(self, t: Trace) -> None:
        if not t.recording or not (t.sampled or t.slow):
            return
        try:
            from geomesa_tpu_torch import metrics

            metrics.traces_captured.inc()
            if t.slow:
                metrics.slow_queries.inc()
        except Exception:  # pragma: no cover - observability must not break
            pass
        with self._lock:
            self._ring[t.trace_id] = t
            self._ring.move_to_end(t.trace_id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
        if t.slow and self.slow_log_path:
            self._write_slow(t)

    def _write_slow(self, t: Trace) -> None:
        try:
            doc = t.to_dict()
            line = json.dumps(doc, default=str)
            with self._log_lock:
                d = os.path.dirname(self.slow_log_path)
                if d:
                    os.makedirs(d, exist_ok=True)
              
                with open(self.slow_log_path, "a") as fh:
                    fh.write(line + "\n")
        except Exception:  # pragma: no cover - the log must not break serving
            pass

    def retain(self, t: Trace) -> None:
        """Force-retain a finished trace in the recent-trace ring even
        when head-sampling declined and it beat the slow threshold —
        the SLO engine calls this for requests that breached their
        lane's objective, so the ``/metrics`` exemplar pointing at the
        trace id actually resolves in ``/debug/traces``. No-op for
        unrecorded traces (there is no span tree to show)."""
        if not t.recording:
            return
        with self._lock:
            self._ring[t.trace_id] = t
            self._ring.move_to_end(t.trace_id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)

    # -- read side (the /debug/traces endpoints) ---------------------------

    def get(self, trace_id: str) -> "Trace | None":
        with self._lock:
            return self._ring.get(trace_id)

    def recent(self, limit: int = 50) -> "list[dict]":
        """Newest-first summaries of the retained traces."""
        if limit <= 0:
            return []
        with self._lock:
            traces = list(self._ring.values())
        return [t.summary() for t in reversed(traces[-limit:])]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


TRACER = Tracer()


# -- context helpers --------------------------------------------------------


def current_span():
    """The active span on THIS thread (None when untraced)."""
    sp = _current.get()
    return None if sp is None or sp is _NOOP else sp


def current_trace() -> "Trace | None":
    sp = current_span()
    return sp.trace if sp is not None else None


def current_trace_id() -> str:
    """The active trace id, or "" — the audit-event stamp."""
    t = current_trace()
    return t.trace_id if t is not None else ""


def capture():
    """The current span, to carry across a thread pool: pass the return
    value to :func:`attach` (or ``span(..., parent=ctx)``) on the worker.
    Contextvars are per-thread — a worker that skips this records
    nothing (by design: no implicit thread-locals across pools)."""
    return current_span()


@contextmanager
def attach(ctx):
    """Make ``ctx`` (a captured span, or None) current on this thread
    for the block — the worker-side half of :func:`capture`."""
    token = _current.set(ctx if ctx is not None else None)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextmanager
def span(name: str, parent=None, **attrs):
    """``with span("store.read", pid=3) as sp:`` — a timed child of the
    current span (or of ``parent``, for explicit cross-thread
    parenting). No active trace -> a shared no-op span; ``sp.set(...)``
    always works."""
    p = parent if parent is not None else _current.get()
    if p is None or p is _NOOP:
        yield _NOOP
        return
    sp = p.trace.begin_span(name, p, attrs)
    token = _current.set(sp)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        sp.dur_s = time.perf_counter() - t0
        _current.reset(token)


def record_span(parent, name: str, start_perf: float, dur_s: float, **attrs):
    """Attach an already-timed span under ``parent`` (a captured span):
    queue waits and shared fused launches are timed by the scheduler and
    fanned out to every rider's trace after the fact."""
    if parent is None or parent is _NOOP:
        return None
    return parent.trace.add_finished(name, parent, start_perf, dur_s, attrs)


# -- pretty printer (the CLI's trace command) --------------------------------


def format_trace(doc: dict) -> str:
    """Human-readable tree of a ``Trace.to_dict()`` document (also the
    slow-query log's embedded form)."""
    head = f"trace {doc.get('trace_id')}  {doc.get('name')}  {doc.get('duration_ms')}ms"
    flags = [k for k in ("sampled", "slow") if doc.get(k)]
    if flags:
        head += f"  [{', '.join(flags)}]"
    lines = [head]
    total = doc.get("duration_ms") or 0.0
    root = doc.get("spans")

    def walk(sp: dict, prefix: str, last: bool) -> None:
        branch = "`- " if last else "|- "
        dur = sp.get("dur_ms")
        pct = f" ({dur / total * 100:.0f}%)" if dur is not None and total else ""
        attrs = sp.get("attrs") or {}
        a = "  " + " ".join(f"{k}={v}" for k, v in attrs.items()) if attrs else ""
        lines.append(
            f"{prefix}{branch}{sp['name']:<28} "
            f"{dur if dur is not None else '?':>9}ms{pct}"
            f"  @{sp.get('thread', '')}{a}"
        )
        kids = sp.get("children") or []
        ext = "   " if last else "|  "
        for i, c in enumerate(kids):
            walk(c, prefix + ext, i == len(kids) - 1)

    if root:
        lines.append(f"`- {root['name']:<28} {root.get('dur_ms')}ms  @{root.get('thread', '')}")
        kids = root.get("children") or []
        for i, c in enumerate(kids):
            walk(c, "   ", i == len(kids) - 1)
    else:
        lines.append("(no spans recorded)")
    return "\n".join(lines)


def coverage(doc: dict) -> float:
    """Fraction of the root span's wall time covered by the union of its
    descendant spans' intervals."""
    root = doc.get("spans")
    if not root or not root.get("dur_ms"):
        return 0.0
    intervals: list = []

    def walk(sp: dict) -> None:
        for c in sp.get("children") or []:
            if c.get("dur_ms") is not None:
                intervals.append((c["start_ms"], c["start_ms"] + c["dur_ms"]))
            walk(c)

    walk(root)
    if not intervals:
        return 0.0
    intervals.sort()
    covered = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo
    return min(1.0, covered / root["dur_ms"])
