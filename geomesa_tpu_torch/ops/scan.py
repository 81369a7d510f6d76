"""Columnar staging: the planes the scan kernels read, as tensors.

Counterpart of ``geomesa_tpu/ops/scan.py``. Plane names follow the
counterpart: ``attr`` for scalar columns, ``attr__x``/``attr__y`` for point
coordinates, ``attr__hi``/``attr__lo`` for the two words of int64 columns
(ops/int64lanes.py). One difference: float planes ALWAYS stage as float32
(the counterpart does so only on a TPU), since 32-bit lanes are the
kernels' storage type.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.ops.int64lanes import split_array_np


def stage_columns_host(
    batch: FeatureBatch,
    names: "list[str]",
    start: int = 0,
    stop: "int | None" = None,
) -> dict:
    """The named planes as contiguous numpy arrays in their device storage
    dtypes (float32, int32, uint32)."""
    stop = len(batch) if stop is None else stop
    out = {}
    splits: dict = {}  # attr -> (hi, lo), computed once per i64 column
    for name in names:
        if name.endswith(("__x0", "__y0", "__x1", "__y1")):
            raise NotImplementedError(
                f"{name}: envelope planes of non-point geometries are a "
                "later port slice (ROADMAP, port queue: xz scans)"
            )
        if name.endswith("__x") or name.endswith("__y"):
            col = batch.column(name[:-3])
            arr = col[start:stop, 0 if name.endswith("__x") else 1]
        elif name.endswith("__hi") or name.endswith("__lo"):
            attr = name[:-4]
            if attr not in splits:
                splits[attr] = split_array_np(batch.column(attr)[start:stop])
            arr = splits[attr][0 if name.endswith("__hi") else 1]
        else:
            arr = batch.column(name)[start:stop]
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        if arr.dtype.itemsize != 4:
            raise TypeError(f"plane {name}: {arr.dtype} is not a 32-bit lane")
        out[name] = np.ascontiguousarray(arr)
    return out


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``, bits unchanged."""
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:  # torch tensors are always writable
        a = a.copy()
    return torch.from_numpy(a).to(device)


def stage_columns(
    batch: FeatureBatch,
    names: "list[str]",
    device,
    start: int = 0,
    stop: "int | None" = None,
) -> dict:
    """Slice + upload the named planes as tensors on ``device``."""
    return {
        k: to_tensor(v, device)
        for k, v in stage_columns_host(batch, names, start, stop).items()
    }
