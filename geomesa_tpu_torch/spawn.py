"""The one place the port's serving code creates threads.

Counterpart of ``geomesa_tpu/spawn.py``, trimmed to ``spawn_thread`` and
the context it carries. Contextvars are per thread, so a raw
``threading.Thread`` drops the request contexts the observability layers
live on: the submitting request's tracing span (``tracing.py``), its cost
collector (``ledger.py``) and its degradation collector
(``resilience.py``). ``spawn_thread`` captures them on the spawning thread
and attaches them around the target; ``context=False`` declares a
service thread (the scheduler's workers and watchdog), a loop that
outlives any request and attaches each work item's context itself.
:class:`ContextPool` is the ``ThreadPoolExecutor`` counterpart (reference
line 151): each ``submit`` captures the submitter's set, as the
file-system store's flush writers and prefetch workers need. The
counterpart's compile scope and runtime context checker measure XLA
compiles; the port has no compiler, and carries neither.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["ContextPool", "RequestContext", "spawn_thread"]


class RequestContext:
    """One captured set of per-request contexts: tracing span, cost
    collector, degradation collector (each may be None)."""

    __slots__ = ("trace", "cost", "degraded")

    def __init__(self, trace=None, cost=None, degraded=None):
        self.trace = trace
        self.cost = cost
        self.degraded = degraded

    @staticmethod
    def capture() -> "RequestContext":
        """Snapshot the calling thread's context set."""
        from geomesa_tpu_torch import ledger, resilience, tracing

        return RequestContext(
            trace=tracing.capture(),
            cost=ledger.capture_cost(),
            degraded=resilience.capture_degraded(),
        )

    @contextmanager
    def attach(self):
        """Install the captured set around a worker's work item."""
        from geomesa_tpu_torch import ledger, resilience, tracing

        with tracing.attach(self.trace), ledger.attach_cost(self.cost), \
                resilience.attach_degraded(self.degraded):
            yield


def spawn_thread(target, *, name: str, args=(), kwargs=None, daemon: bool = True,
                 context: bool = True) -> threading.Thread:
    """The ``threading.Thread`` factory (returned unstarted). ``context=True``
    captures the spawner's request contexts now and attaches them around
    ``target``; ``context=False`` declares a service thread. Every thread
    gets a name."""
    ctx = RequestContext.capture() if context else None
    run = target
    if ctx is not None:
        def run(*a, **kw):
            with ctx.attach():
                return target(*a, **kw)

    return threading.Thread(target=run, args=tuple(args), kwargs=dict(kwargs) if kwargs else {},
                            name=name, daemon=daemon)


def _carry(fn, ctx):
    if ctx is None:
        return fn

    def run(*a, **kw):
        with ctx.attach():
            return fn(*a, **kw)

    return run


class ContextPool:
    """The ``ThreadPoolExecutor`` drop-in: ``submit`` captures the
    submitting thread's context set per call and attach it around the
    worker-side run (``map`` captures it once for all its items);
    ``context=False`` builds a plain pool. Supports the executor
    context-manager protocol; ``shutdown`` passes through."""

    __slots__ = ("_ex", "_context")

    def __init__(self, max_workers: int, thread_name_prefix: str = "", context: bool = True):
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=thread_name_prefix or "geomesa-pool")
        self._context = context

    def submit(self, fn, /, *args, **kwargs):
        ctx = RequestContext.capture() if self._context else None
        return self._ex.submit(_carry(fn, ctx), *args, **kwargs)

    def map(self, fn, *iterables):
        """Context-carrying ``Executor.map`` (captured once: map's items
        all belong to the calling thread's current request)."""
        ctx = RequestContext.capture() if self._context else None
        return self._ex.map(_carry(fn, ctx), *iterables)

    def shutdown(self, wait: bool = True, cancel_futures: bool = False):
        self._ex.shutdown(wait=wait, cancel_futures=cancel_futures)

    def __enter__(self) -> "ContextPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
