"""Two-word (hi int32, lo uint32) device representation of int64 columns.

Copy of ``geomesa_tpu/ops/int64lanes.py`` with a torch ``cmp`` in place of
``cmp_jax``. Date/Long columns stage as two planes -- ``attr__hi`` (int32,
arithmetic high word) and ``attr__lo`` (uint32, low word) -- and compares
are lexicographic two-word compares. ``v -> (v >> 32, v & 0xffffffff)`` is
order-isomorphic to int64 under (signed hi, unsigned lo) order, so every
comparison operator carries over exactly (incl. negative epoch-ms values).
"""

from __future__ import annotations

import numpy as np
import torch

HI_SUFFIX = "__hi"
LO_SUFFIX = "__lo"


def split_value(v: int) -> tuple[int, int]:
    """Python int64 -> (signed hi word, unsigned lo word)."""
    v = int(v)
    return v >> 32, v & 0xFFFFFFFF


def split_array_np(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 array -> (int32 hi, uint32 lo) planes."""
    a = np.asarray(arr, dtype=np.int64)
    hi = (a >> np.int64(32)).astype(np.int32)
    lo = (a & np.int64(0xFFFFFFFF)).astype(np.uint64).astype(np.uint32)
    return hi, lo


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or raw int32 storage of one) -> int64 holding the unsigned
    value. Torch has no ordered compares on uint32, so the plain versions
    compare unsigned words widened."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def cmp_lanes(op: str, hi: torch.Tensor, lo: torch.Tensor, vhi: int, vlo: int) -> torch.Tensor:
    """Elementwise ``(hi, lo) <op> (vhi, vlo)``, both sides int64 encoded as
    (signed hi, unsigned lo) words -- the one source of that convention.
    op in {'=', '<>', '<', '<=', '>', '>='}."""
    h = hi.to(torch.int32)
    lw = widen_u32(lo)
    lt = (h < vhi) | ((h == vhi) & (lw < vlo))
    eq = (h == vhi) & (lw == vlo)
    if op == "=":
        return eq
    if op == "<>":
        return ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    if op == ">=":
        return ~lt
    raise ValueError(op)


def cmp(op: str, hi: torch.Tensor, lo: torch.Tensor, v: int) -> torch.Tensor:
    """Elementwise ``(hi, lo) <op> v`` where (hi, lo) encode int64 lanes."""
    vhi, vlo = split_value(v)
    if not -(1 << 31) <= vhi < (1 << 31):
        raise OverflowError(f"{v} is outside the int64 lane range")
    return cmp_lanes(op, hi, lo, vhi, vlo)
