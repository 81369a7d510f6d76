"""Morton (z-order) bit interleave.

Copy of ``geomesa_tpu/curves/zorder.py``: the numpy forms on uint64 lanes
(host planning and the host oracle) and torch counterparts of its device
encodes, which return the key as a (hi, lo) uint32 lane pair.

- 2D: 31 bits per dimension -> 62-bit z. Bit ``2k`` of z is bit ``k`` of
  x, bit ``2k+1`` is bit ``k`` of y.
- 3D: 21 bits per dimension -> 63-bit z. Bit ``3k`` is bit ``k`` of x,
  ``3k+1`` y, ``3k+2`` t.

Torch has int64 bit operations on the card, so the device encodes spread
each dimension in int64 (every mask below is under 2^63, and a 62/63-bit
key never reaches the sign bit) and split the key into its two words
after; the counterpart spreads in uint32 halves because a TPU has no
64-bit lanes. The words are those of ``encode_*_np`` viewed as
``(z >> 32, z & 0xffffffff)``.

Inputs are nonnegative integers already clamped to the dimension's
precision.
"""

from __future__ import annotations

import numpy as np
import torch

U = np.uint64


def u64_hi_lo(v) -> "tuple[np.ndarray, np.ndarray]":
    """uint64 value(s) -> (hi, lo) uint32 lane pair: the 64-bit key lane
    convention of the key planes and the scan bounds."""
    v = np.asarray(v, dtype=np.uint64)
    return (
        (v >> U(32)).astype(np.uint32),
        (v & U(0xFFFFFFFF)).astype(np.uint32),
    )


# ---------------------------------------------------------------------------
# 2D (Z2): 31 bits/dim
# ---------------------------------------------------------------------------

MAX_MASK_2D = 0x7FFFFFFF  # 31 bits

_M2_INT = (
    0x00000000FFFFFFFF,
    0x0000FFFF0000FFFF,
    0x00FF00FF00FF00FF,
    0x0F0F0F0F0F0F0F0F,
    0x3333333333333333,
    0x5555555555555555,
)
_M2 = [U(m) for m in _M2_INT]


def split_2d_np(x: np.ndarray) -> np.ndarray:
    """Spread the low 31 bits of each lane to even bit positions."""
    x = np.asarray(x).astype(np.uint64) & U(MAX_MASK_2D)
    x = (x ^ (x << U(32))) & _M2[0]
    x = (x ^ (x << U(16))) & _M2[1]
    x = (x ^ (x << U(8))) & _M2[2]
    x = (x ^ (x << U(4))) & _M2[3]
    x = (x ^ (x << U(2))) & _M2[4]
    x = (x ^ (x << U(1))) & _M2[5]
    return x


def combine_2d_np(z: np.ndarray) -> np.ndarray:
    """Gather even bit positions back into a 31-bit lane."""
    x = np.asarray(z).astype(np.uint64) & _M2[5]
    x = (x ^ (x >> U(1))) & _M2[4]
    x = (x ^ (x >> U(2))) & _M2[3]
    x = (x ^ (x >> U(4))) & _M2[2]
    x = (x ^ (x >> U(8))) & _M2[1]
    x = (x ^ (x >> U(16))) & _M2[0]
    x = (x ^ (x >> U(32))) & U(MAX_MASK_2D)
    return x


def encode_2d_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(x, y) 31-bit lanes -> 62-bit z (uint64)."""
    return split_2d_np(x) | (split_2d_np(y) << U(1))


def decode_2d_np(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    z = np.asarray(z).astype(np.uint64)
    return combine_2d_np(z), combine_2d_np(z >> U(1))


# ---------------------------------------------------------------------------
# 3D (Z3): 21 bits/dim
# ---------------------------------------------------------------------------

MAX_MASK_3D = 0x1FFFFF  # 21 bits

_M3_INT = (
    0x00001F00000000FFFF,
    0x00001F0000FF0000FF,
    0x100F00F00F00F00F,
    0x10C30C30C30C30C3,
    0x1249249249249249,
)
_M3 = [U(m) for m in _M3_INT]


def split_3d_np(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each lane to every-3rd bit positions."""
    x = np.asarray(x).astype(np.uint64) & U(MAX_MASK_3D)
    x = (x | (x << U(32))) & _M3[0]
    x = (x | (x << U(16))) & _M3[1]
    x = (x | (x << U(8))) & _M3[2]
    x = (x | (x << U(4))) & _M3[3]
    x = (x | (x << U(2))) & _M3[4]
    return x


def combine_3d_np(z: np.ndarray) -> np.ndarray:
    x = np.asarray(z).astype(np.uint64) & _M3[4]
    x = (x ^ (x >> U(2))) & _M3[3]
    x = (x ^ (x >> U(4))) & _M3[2]
    x = (x ^ (x >> U(8))) & _M3[1]
    x = (x ^ (x >> U(16))) & _M3[0]
    x = (x ^ (x >> U(32))) & U(MAX_MASK_3D)
    return x


def encode_3d_np(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(x, y, t) 21-bit lanes -> 63-bit z (uint64)."""
    return split_3d_np(x) | (split_3d_np(y) << U(1)) | (split_3d_np(t) << U(2))


def decode_3d_np(z: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = np.asarray(z).astype(np.uint64)
    return combine_3d_np(z), combine_3d_np(z >> U(1)), combine_3d_np(z >> U(2))


# ---------------------------------------------------------------------------
# torch device encodes: int64 spread, then the (hi, lo) uint32 split
# ---------------------------------------------------------------------------


def _split_2d_t(v: torch.Tensor) -> torch.Tensor:
    x = v.to(torch.int64) & MAX_MASK_2D
    x = (x ^ (x << 32)) & _M2_INT[0]
    x = (x ^ (x << 16)) & _M2_INT[1]
    x = (x ^ (x << 8)) & _M2_INT[2]
    x = (x ^ (x << 4)) & _M2_INT[3]
    x = (x ^ (x << 2)) & _M2_INT[4]
    x = (x ^ (x << 1)) & _M2_INT[5]
    return x


def _split_3d_t(v: torch.Tensor) -> torch.Tensor:
    x = v.to(torch.int64) & MAX_MASK_3D
    x = (x | (x << 32)) & _M3_INT[0]
    x = (x | (x << 16)) & _M3_INT[1]
    x = (x | (x << 8)) & _M3_INT[2]
    x = (x | (x << 4)) & _M3_INT[3]
    x = (x | (x << 2)) & _M3_INT[4]
    return x


def _hi_lo_t(z: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Nonnegative int64 keys -> (hi, lo) uint32 words, bits kept."""
    hi = (z >> 32).to(torch.int32).view(torch.uint32)
    lo = (z & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)
    return hi, lo


def encode_2d_t(x: torch.Tensor, y: torch.Tensor):
    """Torch 2D Morton encode of integer lanes to the (hi, lo) uint32
    pair (counterpart: ``encode_2d_jax``)."""
    return _hi_lo_t(_split_2d_t(x) | (_split_2d_t(y) << 1))


def encode_3d_hi_lo_t(x: torch.Tensor, y: torch.Tensor, t: torch.Tensor):
    """Torch 3D Morton encode of integer lanes to the (hi, lo) uint32
    pair (counterpart: ``encode_3d_hi_lo_jax``)."""
    z = _split_3d_t(x) | (_split_3d_t(y) << 1) | (_split_3d_t(t) << 2)
    return _hi_lo_t(z)
