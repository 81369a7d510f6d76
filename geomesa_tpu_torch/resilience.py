"""Failure-domain isolation and graceful degradation for the serving path.

Counterpart of ``geomesa_tpu/resilience.py``. Three pieces:

- **Fault taxonomy.** :func:`classify` maps an exception on the serving
  path to ``RETRYABLE`` (transient: I/O hiccups, an injected
  ``FailpointError``, a kernel launch that reported a CUDA error, the
  counterpart's non-OOM ``XlaRuntimeError``: retry with jittered
  backoff), ``DEGRADABLE`` (the work is lost but a cheaper rung can still
  answer: an OOM, a stuck launch, a corrupt or unreachable partition) or
  ``FATAL`` (bad requests, programming errors, and the flow-control
  signals 429/504, which reach the client untouched).
- **Circuit breakers.** :class:`CircuitBreaker` per domain: ``device``
  (launch failures), ``cache`` (resident staging), ``wal`` (streaming
  appends) and the keyed ``partition`` breakers (one per partition read).
  A breaker is ``closed`` until ``resilience.breaker.failures`` failures
  in a row, then ``open`` (callers take the degradation rung at once) for
  ``resilience.breaker.cooldown.s``, then ``half-open``: one probe goes
  through; its success closes the breaker, its failure opens it again.
  An opening breaker asks the flight recorder for a bundle
  (``slo.on_breaker_open``).
- **Degradation accounting.** A layer that answers below the requested
  rung calls :func:`note_degraded` with a reason of :data:`REASONS`; the
  server installs a collector per request (:func:`collect_degraded`) and
  stamps the reasons into the ``X-Degraded`` header and the audit event.
  The collector crosses the scheduler's workers explicitly
  (:func:`capture_degraded` / :func:`attach_degraded`).

Everything is gated by ``resilience.enabled`` / ``resilience.degrade``,
and :func:`brownout` reads the scheduler's ``queue_pressure``. The
counterpart's runtime-checker observer seams are not in the port.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from contextlib import contextmanager

__all__ = [
    "DEGRADABLE", "FATAL", "REASONS", "RETRYABLE",
    "CircuitBreaker", "LaunchStuckError", "PartitionUnavailableError",
    "attach_degraded", "backoff_sleeps", "breaker", "brownout",
    "cache_breaker", "capture_degraded", "classify", "collect_degraded",
    "current_degraded", "degrade_allowed", "device_breaker", "enabled",
    "is_oom", "note_degraded", "open_partition_breakers", "partition_breaker",
    "reset", "retry_call", "snapshot", "wal_breaker",
]

RETRYABLE = "retryable"
DEGRADABLE = "degradable"
FATAL = "fatal"

#: breaker-state gauge encoding (geomesa_resilience_breaker_state)
_STATE_CODE = {"closed": 0, "half-open": 1, "open": 2}


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


def degrade_allowed() -> bool:
    """Whether degraded (stamped) answers may be served instead of failing:
    ``resilience.degrade`` on top of the master switch."""
    from geomesa_tpu_torch.conf import sys_prop

    return enabled() and bool(sys_prop("resilience.degrade"))


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


def classify(exc: BaseException) -> str:
    """Map a serving-path exception to its fault class (module docstring).
    The flow-control signals (429 ``RejectedError``, 504
    ``DeadlineExpired``) are FATAL on purpose: they are the backpressure
    contract with the client, never retried or degraded away."""
    from geomesa_tpu_torch.kernels import KernelLaunchError
    from geomesa_tpu_torch.sched.scheduler import DeadlineExpired, RejectedError
    from geomesa_tpu_torch.store.fs import PartitionCorruptError

    if isinstance(exc, (RejectedError, DeadlineExpired)):
        return FATAL
    if isinstance(exc, (LaunchStuckError, PartitionUnavailableError)):
        return DEGRADABLE
    if is_oom(exc):
        return DEGRADABLE
    if isinstance(exc, PartitionCorruptError):
        return DEGRADABLE
    if isinstance(exc, FileNotFoundError):
        return FATAL  # a real state (a collected generation): refresh, not retry
    if isinstance(exc, OSError):
        return RETRYABLE  # FailpointError among them: transient injection
    if isinstance(exc, KernelLaunchError):
        return RETRYABLE  # a transient device runtime fault (non-OOM)
    return FATAL


def retry_call(fn, domain: str = "device"):
    """``fn()`` with bounded, jittered retries of RETRYABLE faults
    (``resilience.retries`` sleeps of ``resilience.backoff.ms``, doubling,
    their sum capped by ``resilience.backoff.cap.ms``). Other faults, and
    the last retryable one, reach the caller."""
    from geomesa_tpu_torch.conf import sys_prop

    if not enabled():
        return fn()
    sleeps = backoff_sleeps(int(sys_prop("resilience.retries")),
                            float(sys_prop("resilience.backoff.ms")),
                            float(sys_prop("resilience.backoff.cap.ms")))
    while True:
        try:
            return fn()
        except Exception as e:
            if classify(e) != RETRYABLE:
                raise
            delay = next(sleeps, None)
            if delay is None:
                raise  # the retry budget is spent
            from geomesa_tpu_torch import ledger, metrics

            metrics.resilience_retries.inc(domain=domain)
            ledger.charge("retries", 1)
            time.sleep(delay)


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
        from geomesa_tpu_torch import metrics

        metrics.resilience_breaker_transitions.inc(domain=self.domain, to=to)
        if self.domain in ("device", "cache"):
            # singleton domains publish their state; the keyed partition
            # domain publishes open-breaker counts instead
            metrics.resilience_breaker_state.set(_STATE_CODE[to], domain=self.domain)

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
        opened = False
        with self._lock:
            self._consecutive += 1
            if self._state == "half-open":
                self._transition_locked("open")
                opened = True
            elif self._state == "closed" and self._consecutive >= self.failures:
                self._transition_locked("open")
                opened = True
        if opened:
            # the postmortem bundle outside the breaker lock (file I/O);
            # rate limits and the enabled gates live in the recorder
            try:
                from geomesa_tpu_torch import slo

                slo.on_breaker_open(self.domain)
            except Exception:
                pass

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
#: keyed (per-partition) breakers kept at most this many; closed ones are
#: evicted first, so an open breaker survives to its half-open
_PARTITION_BREAKERS_MAX = 1024


def breaker(domain: str) -> CircuitBreaker:
    """The process-wide breaker of a singleton domain."""
    with _breakers_lock:
        b = _breakers.get(domain)
        if b is None:
            b = _breakers[domain] = CircuitBreaker(domain, domain=domain)
        return b


def device_breaker() -> CircuitBreaker:
    return breaker("device")


def cache_breaker() -> CircuitBreaker:
    """The breaker of resident staging: an open one sends requests to the
    store path without paying another staging attempt."""
    return breaker("cache")


def wal_breaker() -> CircuitBreaker:
    """The breaker of write-ahead-log I/O: while it is open, streaming
    appends fail fast (no ack is promised against a log that cannot take
    it)."""
    return breaker("wal")


def partition_breaker(type_name: str, pid) -> CircuitBreaker:
    """The keyed breaker guarding reads of ONE partition. The registry is
    bounded: when full, the oldest closed keyed breaker is evicted (with
    none closed, the oldest keyed one)."""
    key = ("partition", type_name, pid)
    with _breakers_lock:
        b = _breakers.get(key)
        if b is None:
            keyed = [k for k in _breakers if isinstance(k, tuple)]
            if len(keyed) >= _PARTITION_BREAKERS_MAX:
                for k in keyed:
                    if _breakers[k]._state == "closed":
                        del _breakers[k]
                        break
                else:
                    del _breakers[keyed[0]]
            b = _breakers[key] = CircuitBreaker(f"partition:{type_name}:{pid}", domain="partition")
        return b


def open_partition_breakers() -> int:
    with _breakers_lock:
        keyed = [b for k, b in _breakers.items() if isinstance(k, tuple)]
    return sum(1 for b in keyed if b.state != "closed")


def snapshot() -> dict:
    """Breaker states for ``/readyz``: the singleton domains always appear
    (created closed on first ask), with the count of open partition
    breakers."""
    device_breaker()
    cache_breaker()
    wal_breaker()
    with _breakers_lock:
        singles = {k: b for k, b in _breakers.items() if isinstance(k, str)}
    doc = {k: b.snapshot() for k, b in sorted(singles.items())}
    doc["partition_open"] = open_partition_breakers()
    return doc


def brownout(scheduler) -> bool:
    """Is the scheduler's admission queue past
    ``resilience.brownout.queue.frac`` of its bound? The live layer's
    compactor yields to serving while it is (``degrade_allowed`` and a
    scheduler given)."""
    if scheduler is None or not degrade_allowed():
        return False
    from geomesa_tpu_torch.conf import sys_prop

    frac = float(sys_prop("resilience.brownout.queue.frac"))
    if frac <= 0:
        return False
    queued, bound = scheduler.queue_pressure()
    return queued >= frac * max(bound, 1)


def reset() -> None:
    """Drop every breaker and its state (test isolation)."""
    from geomesa_tpu_torch import metrics

    with _breakers_lock:
        _breakers.clear()
    for domain in ("device", "cache", "wal"):
        metrics.resilience_breaker_state.set(0, domain=domain)


# the per-request degradation collector; None outside a serving request
_collector: contextvars.ContextVar = contextvars.ContextVar("geomesa_torch_degraded", default=None)


#: the bounded reason enum: an unlisted reason still collects, but its
#: metric counts it under "other"
REASONS = frozenset({
    "device-breaker-open", "device-launch-failed", "launch-stuck", "device-oom",
    "resident-unavailable", "cache-breaker-open", "partition-unavailable",
    "brownout-pushdown", "mesh-degraded", "ingest-degraded", "wal-replay-truncated",
    "replica-lag", "replica-degraded", "reprovision-installing",
})


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
    rung: collected inside a request, counted by the metric always."""
    from geomesa_tpu_torch import ledger, metrics

    metrics.resilience_degraded.inc(reason=reason if reason in REASONS else "other")
    ledger.charge("degraded", 1)
    reasons = _collector.get()
    if reasons is not None and reason not in reasons:
        reasons.append(reason)


def current_degraded() -> "list[str]":
    reasons = _collector.get()
    return list(reasons) if reasons else []


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
