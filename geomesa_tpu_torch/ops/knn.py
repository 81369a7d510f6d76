"""k-nearest-neighbour distance and selection over resident point planes.

Counterpart of the fused function inside ``DeviceIndex.knn`` in
``geomesa_tpu/device_cache.py`` (distance, mask, ``jax.lax.top_k``): XLA
work there, no Pallas kernel, so plain torch ops here that run alike on
CPU and CUDA tensors.

The distance is defined once, so that both devices give the same bits:

- the longitude factor ``c = float32(cos(radians(float64(float32(py)))))``
  is computed on the host in float64 and rounded once (a library float32
  ``cos`` differs between XLA, torch and the correctly rounded value in
  the last bit);
- ``dx = (x - qx) * c`` and ``dy = y - qy`` are float32 ops, each rounded;
- ``d2 = float32(float64(dx) * float64(dx) + float64(dy * dy))``: the
  product of two float32 values is exact in float64, so this is the
  reference's fused ``fma(dx, dx, dy * dy)`` but for a float64 sum that
  lands exactly on a float32 midpoint. Separate torch ops leave no
  contraction for a compiler to choose.

Selection keeps the reference's tie rule (equal distances prefer the
earlier row) without relying on ``torch.topk``'s order among equal
values: each row's key is ``(float32 bits of d2) << 32 | row``, unique,
and for ``d2 >= 0`` (and ``+inf``) the bits order like the values.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lon_factor(py: float) -> float:
    """The longitude factor at latitude ``py``, a float32 value."""
    return float(np.float32(math.cos(math.radians(float(np.float32(py))))))


def query_vector(px: float, py: float, r: float, c: float, device) -> torch.Tensor:
    """float32 ``[qx, qy, r, c]`` on ``device``: every constant of the
    distance and the radius box, rounded to float32 once."""
    return torch.tensor([px, py, r, c], dtype=torch.float32, device=device)


def knn_d2(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """float32 squared lat-corrected distance of each row to ``q``'s target
    (``q`` from :func:`query_vector`)."""
    dx = ((x - q[0]) * q[3]).double()
    dy = y - q[1]
    return (dx * dx + (dy * dy).double()).float()


def radius_box(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rows inside the raw-degree box of half-extent ``q[2]`` around the
    target, compared in float32 (a NaN coordinate is never inside)."""
    return ((x - q[0]).abs() <= q[2]) & ((y - q[1]).abs() <= q[2])


def knn_select(d2: torch.Tensor, k: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """(row ids int64, d2 float32) of the ``k`` smallest finite entries of
    ``d2``, nearest first, equal distances in row order. Masked rows carry
    ``+inf`` and never come back; fewer than ``k`` finite rows give fewer
    results, ``k <= 0`` none."""
    n = d2.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return (torch.empty(0, dtype=torch.int64, device=d2.device),
                torch.empty(0, dtype=torch.float32, device=d2.device))
    rows = torch.arange(n, dtype=torch.int64, device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | rows
    top = torch.topk(key, k, largest=False, sorted=True).values
    dist = (top >> 32).to(torch.int32).view(torch.float32)
    ok = torch.isfinite(dist)
    return (top & 0xFFFFFFFF)[ok], dist[ok]


def knn(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor, k: int,
        mask: "torch.Tensor | None" = None) -> "tuple[torch.Tensor, torch.Tensor]":
    """The whole kNN pass: distance, the radius box AND ``mask`` (None:
    every row), then :func:`knn_select`."""
    m = radius_box(x, y, q)
    if mask is not None:
        m &= mask
    d2 = torch.where(m, knn_d2(x, y, q), torch.tensor(float("inf"), device=x.device))
    return knn_select(d2, k)
