"""Runtime system properties the port reads.

Counterpart of ``geomesa_tpu/conf.py``, trimmed to the keys of the device
query scheduler (``sched.*``), the launch watchdog and circuit breaker
(``resilience.*``), the loose-bbox default of the resident index
(``query.loose.bbox``) and the memtable size that hints a streaming
index's capacity (``stream.memtable.rows``). Each key has a
default, an environment override (``GEOMESA_TPU_<NAME>`` with dots as
underscores) and a programmatic override for tests (``set_prop`` /
``clear_prop`` or the ``prop_override`` context manager); the override wins
over the environment, the environment over the default.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


def _parse_bool(v) -> bool:
    return str(v).strip().lower() in ("true", "1", "t", "yes", "on")


# name -> (default, parser)
_DEFS = {
    # device query scheduler (sched/scheduler.py): admission bound, worker
    # count, fusion window and width, default deadline, the static
    # Retry-After fallback
    "sched.max.queue": (128, int),
    "sched.max.inflight": (2, int),
    "sched.fusion.window.ms": (2.0, float),
    "sched.max.fusion": (64, int),
    "sched.default.deadline.ms": (30_000.0, float),
    "sched.retry.after.s": (1.0, float),
    # fault-tolerant serving (resilience.py): the master switch, the
    # breaker's failure threshold and cooldown, the launch watchdog budget
    "resilience.enabled": (True, _parse_bool),
    "resilience.breaker.failures": (5, int),
    "resilience.breaker.cooldown.s": (5.0, float),
    "resilience.launch.timeout.s": (30.0, float),
    # answer bbox(+during) queries straight from the index key at cell
    # granularity when a call passes loose=None (ref geomesa.loose.bbox)
    "query.loose.bbox": (False, _parse_bool),
    # rows a live layer buffers before it compacts: a resident streaming
    # index takes it as headroom in its capacity hint
    "stream.memtable.rows": (1 << 15, int),
}

_overrides: dict = {}


def _env_key(name: str) -> str:
    return "GEOMESA_TPU_" + name.upper().replace(".", "_")


def sys_prop(name: str):
    """Resolve a property: programmatic override > environment > default."""
    if name not in _DEFS:
        raise KeyError(f"unknown system property {name!r}")
    default, parse = _DEFS[name]
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get(_env_key(name))
    if env is not None:
        return parse(env)
    return default


def set_prop(name: str, value) -> None:
    if name not in _DEFS:
        raise KeyError(f"unknown system property {name!r}")
    _overrides[name] = _DEFS[name][1](value)


def clear_prop(name: str) -> None:
    _overrides.pop(name, None)


_MISSING = object()


@contextmanager
def prop_override(name: str, value):
    prev = _overrides.get(name, _MISSING)
    set_prop(name, value)
    try:
        yield
    finally:
        if prev is _MISSING:
            clear_prop(name)
        else:
            _overrides[name] = prev
