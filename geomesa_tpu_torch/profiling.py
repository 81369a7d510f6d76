"""Timing and tracing instrumentation.

Copy of ``geomesa_tpu/profiling.py`` (ref role: geomesa-utils
MethodProfiling.profile wrappers, debug-log timings around the planning
and scan phases):

- :func:`profile`: context manager accumulating wall time per label into
  a process-wide registry (the MethodProfiling analog); :func:`profiled`
  is its decorator form
- :func:`timings` / :func:`reset` / :func:`report`: read back, clear and
  print the registry
- :func:`device_trace`: wrap a block in a ``torch.profiler`` trace for
  kernel-level inspection

Where the port differs: the counterpart's ``device_trace`` dumps a
``jax.profiler`` TensorBoard directory; the port's writes one Chrome trace
per block (``<log_dir>/<name>-<k>.pt.trace.json``: ``name`` the caller's,
the request's trace id on the query path, ``k`` the process's block
counter), with the CUDA activities when the card is in use (ROADMAP
section 3, deliberate divergences). Open it in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``.
"""

from __future__ import annotations

import functools
import itertools
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

from geomesa_tpu_torch.locking import checked_lock


@dataclass
class _Timer:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def observe(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


@dataclass
class _Registry:
    timers: dict = field(default_factory=lambda: defaultdict(_Timer))
    lock: object = field(default_factory=lambda: checked_lock("profiling.registry"))


_REG = _Registry()


@contextmanager
def profile(label: str):
    """``with profile("planning"): ...``: accumulate wall time under a
    label. Nestable and thread-safe; negligible overhead when unused."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _REG.lock:
            _REG.timers[label].observe(dt)


def profiled(label: "str | None" = None):
    """Decorator form of :func:`profile`."""

    def deco(fn):
        name = label or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with profile(name):
                return fn(*a, **kw)

        return wrapper

    return deco


def timings() -> dict:
    """label -> {count, total_ms, mean_ms, max_ms} snapshot."""
    with _REG.lock:
        return {
            label: {
                "count": t.count,
                "total_ms": round(t.total_s * 1e3, 3),
                "mean_ms": round(t.total_s / t.count * 1e3, 3) if t.count else 0.0,
                "max_ms": round(t.max_s * 1e3, 3),
            }
            for label, t in _REG.timers.items()
        }


def reset() -> None:
    with _REG.lock:
        _REG.timers.clear()


def report() -> str:
    """Human-readable table of accumulated timings."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total_ms"])
    if not rows:
        return "(no profile data)"
    out = [f"{'label':<40} {'count':>7} {'total ms':>10} {'mean ms':>9} {'max ms':>9}"]
    for label, t in rows:
        out.append(
            f"{label:<40} {t['count']:>7} {t['total_ms']:>10.1f} "
            f"{t['mean_ms']:>9.2f} {t['max_ms']:>9.2f}"
        )
    return "\n".join(out)


#: one profiler session at a time in a process: a block that finds one
#: running (another thread's, or an enclosing block) runs untraced
_TRACE_LOCK = checked_lock("profiling.device_trace")
_BLOCKS = itertools.count()


def _cuda_in_use() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextmanager
def device_trace(log_dir: str, name: "str | None" = None):
    """Record the enclosed block with ``torch.profiler`` (the CPU
    activities, and the CUDA ones, kernels and copies, when the card is in
    use) and write it as one Chrome trace,
    ``<log_dir>/<name or "trace">-<k>.pt.trace.json``. Yields the file's
    path, or None when another block's session is running (that block
    runs untraced)."""
    if not _TRACE_LOCK.acquire(blocking=False):
        yield None
        return
    try:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if _cuda_in_use():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{name or 'trace'}-{next(_BLOCKS)}.pt.trace.json")
        with torch_profile(activities=activities) as prof:
            yield path
        prof.export_chrome_trace(path)
    finally:
        _TRACE_LOCK.release()
