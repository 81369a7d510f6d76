"""Z2 space-filling curve dimensions: (lon, lat).

Copy of ``geomesa_tpu/curves/z2.py``, trimmed to the sfc's dimensions and
key encode (no z-range planner): 31-bit quantization of lon in
[-180, 180] and lat in [-90, 90], Morton-interleaved x-first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.normalize import NormalizedLat, NormalizedLon


@dataclass(frozen=True)
class Z2SFC:
    precision: int = 31

    @property
    def lon(self):
        return NormalizedLon(self.precision)

    @property
    def lat(self):
        return NormalizedLat(self.precision)

    def index(self, x, y) -> np.ndarray:
        """Vectorized host encode (lon, lat) -> z (uint64)."""
        nx = self.lon.normalize(x).astype(np.uint64)
        ny = self.lat.normalize(y).astype(np.uint64)
        return zorder.encode_2d_np(nx, ny)

    def index_hi_lo(self, x: torch.Tensor, y: torch.Tensor):
        """Encode on the tensors' device to the (hi, lo) uint32 key words,
        quantizing in float64: bit for bit the host :meth:`index`."""
        return zorder.encode_2d_t(self.lon.normalize_t(x), self.lat.normalize_t(y))
