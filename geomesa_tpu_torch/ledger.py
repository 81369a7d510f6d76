"""Per-request cost collection: who spends the device's time.

Counterpart of ``geomesa_tpu/ledger.py``, trimmed to the request's cost
collector: :class:`RequestCost`, :func:`collect_cost`, :func:`charge`,
:func:`capture_cost` and :func:`attach_cost`. The
scheduler carries the collector to its workers and charges each rider of
a fused launch its fair share (duration / riders), so summing over
requests gives the device time actually spent. The counterpart's
``compile_scope`` and ``_note_jit_cache`` measure XLA compiles and jit
cache hits; the port runs eagerly and has no compiler, so they are left
out, as are the process-wide aggregation and the top-K ring.
"""

from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager

__all__ = ["FIELDS", "RequestCost", "attach_cost", "capture_cost", "charge", "collect_cost"]

#: the fields a request is charged (every ``charge`` names one)
FIELDS = (
    "stage_seconds",  # host column staging of the store path's scans
    "device_launches",  # device scan launches this request rode
    "device_seconds",  # fair-share device execution time (dur / riders)
    "fusion_width",  # widest fused launch this request rode (max)
    "join_candidates",  # candidate pairs expanded by join refinement
    "join_pairs",  # pairs this request's spatial joins emitted
    "read_bytes",  # partition-file bytes read for this request
    "read_seconds",  # host read time (prefetch workers included)
    "decode_seconds",  # partition-file bytes to FeatureBatch decode time
    "chunks_read",  # v2 chunks actually read
    "chunks_pruned",  # v2 chunks skipped before read/decode
)

#: fields folded with max() instead of sum()
_MAX_FIELDS = frozenset({"fusion_width"})


class RequestCost:
    """One request's cost accumulator; charged from the submitting thread
    and scheduler workers, every change under the instance lock."""

    __slots__ = ("fields", "_lock")

    def __init__(self):
        self.fields: dict = {}
        self._lock = threading.Lock()

    def charge(self, field: str, amount: float) -> None:
        if field not in FIELDS:
            raise KeyError(f"unknown ledger field {field!r} (see FIELDS)")
        with self._lock:
            if field in _MAX_FIELDS:
                self.fields[field] = max(self.fields.get(field, 0.0), float(amount))
            else:
                self.fields[field] = self.fields.get(field, 0.0) + float(amount)

    def snapshot_fields(self) -> dict:
        with self._lock:
            return dict(self.fields)


_cost: contextvars.ContextVar = contextvars.ContextVar("geomesa_torch_cost", default=None)


@contextmanager
def collect_cost():
    """Install a fresh :class:`RequestCost` for a request; yields it."""
    cost = RequestCost()
    token = _cost.set(cost)
    try:
        yield cost
    finally:
        _cost.reset(token)


def charge(field: str, amount: float) -> None:
    """Charge the current request's collector; a no-op outside a request."""
    cost = _cost.get()
    if cost is not None:
        cost.charge(field, amount)


def capture_cost() -> "RequestCost | None":
    """The current collector, to carry to a worker thread."""
    return _cost.get()


@contextmanager
def attach_cost(cost):
    """Attach a captured collector around work on another thread; None
    attaches nothing."""
    if cost is None:
        yield
        return
    token = _cost.set(cost)
    try:
        yield
    finally:
        _cost.reset(token)
