"""Columnar assembly helpers for the result plane.

Copy of ``geomesa_tpu/results/columnar.py``.

The hot-path rule of the whole package: a result column is born as a
numpy buffer (vectorized take over the staged host mirror) and stays a
buffer until pyarrow wraps it — no per-feature Python between the
device's compacted row ids and the wire.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType

#: numpy dtype kind -> SFT attribute type for extra result columns
_EXTRA_TYPES = (
    ("f", "Double"),
    ("i", "Long"),
    ("u", "Long"),
    ("b", "Boolean"),
)


def _extra_type_name(arr: np.ndarray) -> str:
    for kind, tname in _EXTRA_TYPES:
        if arr.dtype.kind == kind:
            return tname
    return "String"


def with_extra_columns(batch: FeatureBatch, extra: dict) -> FeatureBatch:
    """A new batch whose SFT grows one REAL attribute per ``extra``
    entry (name -> per-row values) — process outputs like kNN
    distances become typed Arrow/BIN-exportable columns instead of a
    GeoJSON-only ``zip`` loop over rendered features. Values are
    coerced as whole arrays (vectorized); names must not collide with
    existing attributes."""
    if not extra:
        return batch
    clash = [n for n in extra if n in batch.sft.attribute_names]
    if clash:
        raise ValueError(f"extra columns {clash} collide with the schema")
    spec = batch.sft.spec
    cols = dict(batch.columns)
    for name, vals in extra.items():
        arr = np.asarray(vals)
        if len(arr) != len(batch):
            raise ValueError(
                f"extra column {name!r} has {len(arr)} rows, "
                f"expected {len(batch)}"
            )
        tname = _extra_type_name(arr)
        if tname == "String":
            arr = arr.astype(object)
        spec += f",{name}:{tname}"
        cols[name] = arr
    sft = SimpleFeatureType.create(batch.sft.type_name, spec)
    return FeatureBatch.from_columns(sft, cols, batch.fids)


def capped_batches(batches, cap: "int | None"):
    """Stream ``batches`` up to ``cap`` total rows (MaxFeatures across
    a multi-batch stream has cross-batch semantics: trim the batch that
    crosses the cap, stop pulling after it — upstream partition reads
    past the cap are never decoded)."""
    if cap is None:
        yield from batches
        return
    left = int(cap)
    for b in batches:
        if left <= 0:
            break
        if len(b) > left:
            b = b.take(np.arange(left))
        left -= len(b)
        if len(b):
            yield b
