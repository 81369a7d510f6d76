"""Named fault-injection points of the serving path.

Counterpart of ``geomesa_tpu/failpoints.py``, trimmed to the evaluation
and arming helpers (reference lines 14-40 and 136-). The port evaluates
(the WAL's and the compaction's at ``geomesa_tpu/store/wal.py:308``,
``:362``, ``:385`` and ``store/stream.py:942``):

- ``fail.sched.worker``  -- a scheduler worker about to execute a claimed
                            group; ``raise`` simulates a worker crash (its
                            requests must fail typed, never hang or vanish)
- ``fail.device.launch`` -- a fused resident launch about to dispatch;
                            ``raise`` simulates a launch failure
- ``fail.stage.oom``     -- a store run's column staging; a raise is
                            treated as an OOM (the run halves)
- ``fail.flush.after_write``    -- the file-system store's new-generation
                                   partition files are written and
                                   checksummed, nothing is published
- ``fail.flush.before_publish`` -- the manifest is about to publish
- ``fail.flush.after_publish``  -- the manifest is published, the old
                                   generation not yet collected
- ``fail.read.io``       -- a partition file is about to be read
                            (transient: the prefetch retry path)
- ``fail.read.corrupt``  -- a partition read reports a checksum mismatch
                            (exercises the quarantine)
- ``fail.wal.append``    -- a WAL record is about to be written (inside
                            the append's retry: a ``raise`` is retried)
- ``fail.wal.rotate``    -- a full WAL segment is about to be sealed
- ``fail.wal.replay``    -- replay is about to scan a WAL segment
- ``fail.compact.publish`` -- a compaction published its generation and
                            dropped its runs; the WAL is not yet truncated

Activation: programmatic (``set_failpoint`` / ``failpoint_override``) or
the ``GEOMESA_TPU_FAILPOINTS`` environment variable, a comma-separated
``name=action`` list. Actions:

- ``kill``     -- SIGKILL this process
- ``exit[:N]`` -- ``os._exit(N)`` (default 1)
- ``raise``    -- raise :class:`FailpointError` every evaluation
- ``raise:N``  -- raise for the first N evaluations, then pass
- ``sleep:MS`` -- sleep MS milliseconds, then pass
- ``off``      -- disarmed (same as absent)
"""

from __future__ import annotations

import os
import signal
import threading
import time
from contextlib import contextmanager

ENV_VAR = "GEOMESA_TPU_FAILPOINTS"

_lock = threading.Lock()
_overrides: dict = {}  # name -> action (programmatic arming)
_counts: dict = {}  # name -> evaluations fired (the raise:N budget)
_env_cache: tuple = (None, {})


class FailpointError(OSError):
    """An armed failpoint fired (an OSError: injected faults classify as
    transient I/O)."""

    def __init__(self, msg: str, name: "str | None" = None):
        super().__init__(msg)
        self.name = name


def _parse(spec: str) -> dict:
    out: dict = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        name, _, action = pair.partition("=")
        out[name.strip()] = (action or "raise").strip()
    return out


def _env_actions() -> dict:
    global _env_cache
    raw = os.environ.get(ENV_VAR)
    if raw == _env_cache[0]:
        return _env_cache[1]
    parsed = _parse(raw) if raw else {}
    _env_cache = (raw, parsed)
    return parsed


def action_for(name: str) -> "str | None":
    """The armed action for ``name`` (programmatic override wins over the
    environment), or None when disarmed."""
    if name in _overrides:
        return _overrides[name]
    return _env_actions().get(name)


def set_failpoint(name: str, action: str) -> None:
    with _lock:
        _overrides[name] = action
        _counts.pop(name, None)  # fresh raise:N budget


def clear_failpoint(name: str) -> None:
    with _lock:
        _overrides.pop(name, None)
        _counts.pop(name, None)


@contextmanager
def failpoint_override(name: str, action: str):
    """Arm ``name`` for the with-body, restoring the previous state."""
    prev = _overrides.get(name)
    set_failpoint(name, action)
    try:
        yield
    finally:
        if prev is None:
            clear_failpoint(name)
        else:
            set_failpoint(name, prev)


def fail_hit(name: str) -> bool:
    """Evaluate a failpoint, returning True instead of raising for
    ``raise`` actions; ``kill``/``exit`` still end the process."""
    action = action_for(name)
    if not action or action == "off":
        return False
    base, _, arg = action.partition(":")
    if base == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if base == "exit":
        os._exit(int(arg or 1))
    if base == "raise":
        if arg:  # raise:N -- only the first N evaluations fire
            with _lock:
                seen = _counts.get(name, 0)
                if seen >= int(arg):
                    return False
                _counts[name] = seen + 1
        return True
    if base == "sleep":  # latency injection: pause, then pass
        time.sleep(max(float(arg or 0), 0.0) / 1e3)
        return False
    raise ValueError(f"unknown failpoint action {action!r} for {name!r}")


def fail_point(name: str) -> None:
    """Evaluate a failpoint at a named site; no-op unless armed."""
    if fail_hit(name):
        raise FailpointError(f"failpoint {name} triggered", name=name)
