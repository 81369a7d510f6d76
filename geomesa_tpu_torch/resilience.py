"""Failure domains of the serving path: the launch watchdog's error, the
device circuit breaker and the degradation collector.

Counterpart of ``geomesa_tpu/resilience.py``, trimmed to what the device
query scheduler uses: :class:`LaunchStuckError`, :func:`enabled`,
:class:`CircuitBreaker` with the process-wide :func:`device_breaker`, and
the per-request degradation collector that crosses to worker threads
(:func:`collect_degraded`, :func:`capture_degraded`,
:func:`attach_degraded`, :func:`note_degraded`), the file-system store's
partition-scoped :class:`PartitionUnavailableError` and the jittered
:func:`backoff_sleeps` of its read retries. The fault taxonomy, the
serving retries, the keyed partition breakers and brownout belong to the
server, which the port does not have yet.

The breaker is ``closed`` until ``resilience.breaker.failures`` failures
in a row, then ``open`` (callers skip the domain) for
``resilience.breaker.cooldown.s``, then ``half-open``: one probe goes
through; its success closes the breaker, its failure opens it again.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from contextlib import contextmanager

__all__ = [
    "CircuitBreaker", "LaunchStuckError", "PartitionUnavailableError",
    "attach_degraded", "backoff_sleeps", "breaker",
    "capture_degraded", "collect_degraded", "device_breaker",
    "enabled", "is_oom", "note_degraded", "reset",
]


class LaunchStuckError(RuntimeError):
    """A device launch exceeded the watchdog budget: the request fails so
    its submitter unblocks; the wedged worker thread is abandoned and
    replaced (a launch cannot be cancelled mid-flight)."""


class PartitionUnavailableError(RuntimeError):
    """Reads of ONE partition failed (retries exhausted, or its checksum
    quarantined it): a partition-scoped, typed fault naming what is
    unreachable, never an anonymous pipeline teardown."""

    def __init__(self, type_name: str, pid, cause: str):
        super().__init__(f"dataset {type_name!r} partition {pid} is unavailable: {cause}")
        self.type_name = type_name
        self.pid = pid


_rng = random.Random()


def backoff_sleeps(retries: int, base_ms: float, cap_ms: float):
    """Yield jittered exponential backoff sleeps (seconds): the k-th is
    ``base * 2^k`` scaled by a uniform [0.5, 1.5) factor. ``cap_ms > 0``
    bounds the cumulative sleep: the generator stops once it is spent."""
    total = 0.0
    base = max(float(base_ms), 0.0)
    for attempt in range(max(int(retries), 0)):
        d = base * (1 << attempt) * (0.5 + _rng.random())
        # d == 0 (immediate retries) spends no budget; the count bounds it
        if cap_ms > 0 and d > 0:
            d = min(d, cap_ms - total)
            if d <= 0:
                return
        total += d
        yield d / 1e3


def enabled() -> bool:
    from geomesa_tpu_torch.conf import sys_prop

    return bool(sys_prop("resilience.enabled"))


def is_oom(exc: BaseException) -> bool:
    """Device or host memory exhaustion: ``torch.cuda.OutOfMemoryError``
    (the counterpart matches XLA's RESOURCE_EXHAUSTED) or a host
    ``MemoryError``. The store path's scan halves its run and retries on
    one."""
    if isinstance(exc, MemoryError):
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    s = str(exc)
    return "out of memory" in s or "Out of memory" in s


class CircuitBreaker:
    """Per-domain failure isolation (the module docstring's state machine).
    Thread-safe; durations are monotonic. ``failures``/``cooldown_s`` None
    read the ``resilience.*`` properties on every use."""

    def __init__(self, name: str, domain: "str | None" = None,
                 failures: "int | None" = None, cooldown_s: "float | None" = None):
        self.name = name
        self.domain = domain or name
        self._failures = None if failures is None else int(failures)
        self._cooldown_s = None if cooldown_s is None else float(cooldown_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_at = 0.0
        self.opens = 0  # lifetime open transitions

    @property
    def failures(self) -> int:
        if self._failures is not None:
            return self._failures
        from geomesa_tpu_torch.conf import sys_prop

        return int(sys_prop("resilience.breaker.failures"))

    @property
    def cooldown_s(self) -> float:
        if self._cooldown_s is not None:
            return self._cooldown_s
        from geomesa_tpu_torch.conf import sys_prop

        return float(sys_prop("resilience.breaker.cooldown.s"))

    def _transition_locked(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        if to == "open":
            self.opens += 1
            self._opened_at = time.monotonic()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request use this domain now? True while closed; while open
        False until the cooldown passes, then one caller gets True (the
        probe), which must report :meth:`record_success` or
        :meth:`record_failure`."""
        if not enabled():
            return True
        with self._lock:
            if self._state == "closed":
                return True
            now = time.monotonic()
            if self._state == "open":
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._transition_locked("half-open")
                self._probe_at = now
                return True
            if now - self._probe_at >= self.cooldown_s:
                self._probe_at = now  # probe lost: hand out another
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._transition_locked("closed")

    def release_probe(self) -> None:
        """Give a half-open probe slot back without an outcome (the probe
        was shed before it reached the domain)."""
        with self._lock:
            if self._state == "half-open":
                self._probe_at = time.monotonic() - self.cooldown_s

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == "half-open":
                self._transition_locked("open")
            elif self._state == "closed" and self._consecutive >= self.failures:
                self._transition_locked("open")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failures,
                "cooldown_s": self.cooldown_s,
                "opens": self.opens,
            }


_breakers_lock = threading.Lock()
_breakers: dict = {}


def breaker(domain: str) -> CircuitBreaker:
    """The process-wide breaker of a domain."""
    with _breakers_lock:
        b = _breakers.get(domain)
        if b is None:
            b = _breakers[domain] = CircuitBreaker(domain, domain=domain)
        return b


def device_breaker() -> CircuitBreaker:
    return breaker("device")


def reset() -> None:
    """Drop every breaker and its state (test isolation)."""
    with _breakers_lock:
        _breakers.clear()


# the per-request degradation collector; None outside a serving request
_collector: contextvars.ContextVar = contextvars.ContextVar("geomesa_torch_degraded", default=None)


@contextmanager
def collect_degraded():
    """Install a fresh per-request collector; yields the ordered,
    deduplicated reason list the request accumulates."""
    reasons: list = []
    token = _collector.set(reasons)
    try:
        yield reasons
    finally:
        _collector.reset(token)


def note_degraded(reason: str) -> None:
    """Record that the current request was answered below its requested
    rung (a no-op outside a request)."""
    reasons = _collector.get()
    if reasons is not None and reason not in reasons:
        reasons.append(reason)


def capture_degraded():
    """The current collector, to carry to a worker thread."""
    return _collector.get()


@contextmanager
def attach_degraded(reasons):
    """Attach a captured collector around work on another thread; None
    attaches nothing."""
    if reasons is None:
        yield
        return
    token = _collector.set(reasons)
    try:
        yield
    finally:
        _collector.reset(token)
