"""Per-request span trees across the serving path.

Counterpart of ``geomesa_tpu/tracing.py``, trimmed to what the device
query scheduler writes: :class:`Trace` and :class:`Span`, the process-wide
:class:`Tracer` that opens a request's trace, and the helpers
:func:`span`, :func:`capture`, :func:`attach` and :func:`record_span`. The
counterpart's ring of recent traces, slow-query log, exports and pretty
printer serve its HTTP endpoints and CLI, which the port does not have
yet, nor its head sampling and slow threshold, which decide what those
keep; a caller keeps the :class:`Trace` it opened and reads its spans, so
opening a trace is the opt-in and every opened trace records.

A trace is one request: an id, a root span and a tree of timed child
spans. Spans nest through a contextvar; contextvars are per thread, so
context crosses to a worker explicitly (:func:`capture` on the submitting
thread, ``with attach(ctx):`` on the worker). Spans timed elsewhere -- the
scheduler's queue wait, a shared fused launch fanned out to every rider --
attach afterwards with :func:`record_span`. Without an open trace, spans
are no-ops.
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
from contextlib import contextmanager

__all__ = [
    "Span", "Trace", "Tracer", "TRACER", "span", "record_span", "capture",
    "attach", "current_span",
]

_current: contextvars.ContextVar = contextvars.ContextVar("geomesa_tpu_torch_span", default=None)


class Span:
    """One timed operation in a trace; ``set(**attrs)`` adds attributes."""

    __slots__ = ("name", "attrs", "start_s", "dur_s", "children", "thread", "trace")

    def __init__(self, name: str, trace: "Trace", start_s: float, attrs):
        self.name = name
        self.trace = trace
        self.start_s = start_s  # relative to the trace's t0
        self.dur_s: "float | None" = None
        self.attrs = dict(attrs) if attrs else {}
        self.children: list = []
        self.thread = threading.current_thread().name

    def set(self, **attrs) -> None:
        # copy on write: a reader may be iterating the old dict
        new = dict(self.attrs)
        new.update(attrs)
        self.attrs = new


class _NoopSpan:
    """Inert span: no active trace."""

    __slots__ = ()
    trace = None

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class Trace:
    """One request's span tree, opened by :meth:`Tracer.trace`."""

    def __init__(self, name: str, trace_id: str):
        self.name = name
        self.trace_id = trace_id
        self.t0 = time.perf_counter()
        self.dur_s: "float | None" = None
        self.lock = threading.Lock()
        self.root = Span(name, self, 0.0, None)

    def begin_span(self, name: str, parent: Span, attrs) -> Span:
        sp = Span(name, self, time.perf_counter() - self.t0, attrs)
        with self.lock:
            parent.children.append(sp)
        return sp

    def add_finished(self, name: str, parent: Span, start_perf: float, dur_s: float,
                     attrs) -> Span:
        """A span timed elsewhere, attached once its duration is known."""
        sp = Span(name, self, start_perf - self.t0, attrs)
        sp.dur_s = dur_s
        with self.lock:
            parent.children.append(sp)
        return sp

    def finish(self) -> None:
        self.dur_s = time.perf_counter() - self.t0
        self.root.dur_s = self.dur_s


class Tracer:
    """Opens request traces."""

    @contextmanager
    def trace(self, name: str, trace_id=None, attrs=None):
        """Open a root span for one request; yields the :class:`Trace`,
        which finishes on exit. Child spans may still attach afterwards
        (a worker completing a request the submitter stopped tracing)."""
        t = Trace(name, str(trace_id or uuid.uuid4().hex[:16]))
        if attrs:
            t.root.set(**attrs)
        token = _current.set(t.root)
        try:
            yield t
        finally:
            _current.reset(token)
            t.finish()


TRACER = Tracer()


def current_span():
    """The active span on this thread (None when untraced)."""
    sp = _current.get()
    return None if sp is None or sp is _NOOP else sp


def capture():
    """The current span, to carry to a worker thread: pass it to
    :func:`attach` (or ``span(..., parent=ctx)``) there."""
    return current_span()


@contextmanager
def attach(ctx):
    """Make ``ctx`` (a captured span, or None) current on this thread for
    the block: the worker's half of :func:`capture`."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


@contextmanager
def span(name: str, parent=None, **attrs):
    """``with span("fusion.launch", queries=8) as sp:`` -- a timed child of
    the current span (or of ``parent``); a shared no-op span without an
    active trace."""
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
    """Attach an already-timed span under ``parent`` (a captured span)."""
    if parent is None or parent is _NOOP:
        return None
    return parent.trace.add_finished(name, parent, start_perf, dur_s, attrs)
