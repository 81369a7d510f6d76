"""The BIN record pack: hit rows' record lanes compacted on the device.

Counterpart of the ``pack`` closure of ``DeviceIndex.bin_rider``
(``geomesa_tpu/device_cache.py:2604``), an XLA program there, torch ops
here that run alike on CPU and CUDA tensors. The record lanes of every
staged row sit in one ``(L, rows)`` int32 matrix (the bits of the
little-endian record words: track hash, dtg seconds, lat and lon float32,
and the label's two words for 24-byte records). A count pass sizes the
answer; the compaction gathers the hit rows' lanes, in mask order, into
a ``(hits, L)`` block whose bytes are the records, copied to the host
once.
"""

from __future__ import annotations

import numpy as np
import torch


def bin_count(mask: torch.Tensor) -> int:
    """The count pass: hit rows of a bool mask."""
    return int(mask.sum())


def bin_compact(mask: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """The compaction on the device: the hit rows' lanes, row after row, as
    a contiguous ``(hits, L)`` int32 tensor. ``lanes`` is the int32
    ``(L, rows)`` matrix, ``mask`` a bool plane over its rows."""
    return lanes.t()[torch.nonzero(mask).squeeze(1)]


def bin_pack(mask: torch.Tensor, lanes: torch.Tensor) -> np.ndarray:
    """:func:`bin_compact`, copied to the host once: the records' bytes."""
    return bin_compact(mask, lanes).cpu().numpy()
