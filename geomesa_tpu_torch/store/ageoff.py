"""Shared age-off sweep (ref: geomesa-accumulo AgeOffIterator, run as a
sweep rather than a compaction hook). Copy of ``geomesa_tpu/store/ageoff.py``.

One implementation for every store: query features strictly older than the
cutoff through the store's own (internal, guard-exempt) query path, then
delete them by id.
"""

from __future__ import annotations

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.query.plan import internal_query


def age_off(store, type_name: str, sft, before_ms: int) -> int:
    """Remove features with ``dtg < before_ms``; returns the count removed."""
    dtg = sft.dtg_field
    if dtg is None:
        raise ValueError(f"{type_name!r} has no Date field")
    old = store.query(type_name, internal_query(ast.Compare("<", dtg, before_ms)))
    return store.delete(type_name, list(old.batch.fids))
