"""Carry resident state across from the JAX package's index.

``planes_from_numpy`` turns the staged planes of the counterpart's
``DeviceIndex`` (``{k: np.asarray(v) for k, v in di._cols.items()}``) into
the port's resident planes, bit for bit, so that
``DeviceIndex.from_planes`` serves from exactly the same state. 32-bit
planes keep their bits and dtype. A float64 plane (the counterpart stages
float64 off a TPU) becomes float32 only when every value survives the
round trip; otherwise it raises, since the port's kernels read float32
lanes and a rounded plane would change answers. The visibility label-id
plane ``__visid`` is an int32 plane like any other; pass the counterpart's
``_vis_vocab`` to ``from_planes`` with it. So are the key planes of either
layout: ``__znx/__zny/__zbt`` (uint32) and the interleaved ``__zbin``
(int32), ``__zhi/__zlo`` (uint32).
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.scan import to_tensor


def planes_from_numpy(cols: "dict[str, np.ndarray]", device) -> "dict[str, torch.Tensor]":
    out = {}
    for k, v in cols.items():
        a = np.asarray(v)
        if a.dtype == np.float64:
            f32 = a.astype(np.float32)
            if not np.array_equal(f32.astype(np.float64), a, equal_nan=True):
                raise ValueError(
                    f"plane {k}: float64 values do not survive float32 lanes"
                )
            a = f32
        if a.dtype not in (np.float32, np.int32, np.uint32) or a.ndim != 1:
            raise TypeError(f"plane {k}: {a.dtype} {a.shape} is not a 32-bit lane plane")
        out[k] = to_tensor(a, device)
    return out
