"""Fixed-precision dimension quantization.

Copy of ``geomesa_tpu/curves/normalize.py``; ``normalize_t`` is the torch
counterpart of its ``normalize_jax``. Semantics follow GeoMesa's
NormalizedDimension:

- ``normalize(v) = maxIndex          if v >= max``
- ``normalize(v) = floor((v - min) * bins / (max - min))  otherwise``

These exact floor/clamp rules are what make z-keys comparable bit-for-bit
with the reference's keys, so they are kept verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class NormalizedDimension:
    """Maps a double in [min, max] onto {0 .. 2**precision - 1}."""

    min: float
    max: float
    precision: int  # bits; <= 31

    @property
    def bins(self) -> int:
        return 1 << self.precision

    @property
    def max_index(self) -> int:
        return self.bins - 1

    def normalize(self, value):
        """Vectorized host quantization; returns int64 ndarray (or scalar)."""
        v = np.asarray(value, dtype=np.float64)
        scale = self.bins / (self.max - self.min)
        idx = np.floor((v - self.min) * scale).astype(np.int64)
        idx = np.where(v >= self.max, self.max_index, idx)
        return np.clip(idx, 0, self.max_index)

    def normalize_t(self, value: torch.Tensor) -> torch.Tensor:
        """Same quantization on a tensor's device; returns int32.

        Always float64 (the counterpart upcasts under scoped x64 before
        quantizing; in float32, 21-bit bins flip). The floor is clamped
        *in float* before the integer cast so values at/above ``max``
        cannot overflow int32, then the ``v >= max`` rule applies."""
        v = value.to(torch.float64)
        scale = self.bins / (self.max - self.min)
        f = torch.floor((v - self.min) * scale)
        f = torch.clamp(f, 0.0, float(self.max_index))
        idx = f.to(torch.int32)
        idx = torch.where(
            v >= self.max, torch.full_like(idx, self.max_index), idx
        )
        return torch.clamp(idx, 0, self.max_index)


def NormalizedLon(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-180.0, 180.0, precision)


def NormalizedLat(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-90.0, 90.0, precision)


def NormalizedTime(precision: int, max_offset: float) -> NormalizedDimension:
    return NormalizedDimension(0.0, max_offset, precision)
