"""Z3 space-filling curve dimensions: (lon, lat, time-offset).

Copy of ``geomesa_tpu/curves/z3.py``, trimmed to the sfc's dimensions,
period and key encode (no z-range planner: the resident scans answer
bbox+during queries by compares, not ranges). 21-bit quantization of
lon/lat and of the time offset within a ``BinnedTime`` period (week by
default), Morton-interleaved x, y, t. The counterpart's native C++ encode
is not copied: the port encodes resident keys on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset
from geomesa_tpu_torch.curves.normalize import (
    NormalizedLat,
    NormalizedLon,
    NormalizedTime,
)


@dataclass(frozen=True)
class Z3SFC:
    period: TimePeriod = TimePeriod.WEEK
    precision: int = 21

    @property
    def lon(self):
        return NormalizedLon(self.precision)

    @property
    def lat(self):
        return NormalizedLat(self.precision)

    @property
    def time(self):
        return NormalizedTime(self.precision, float(max_offset(self.period)))

    def index(self, x, y, t) -> np.ndarray:
        """Vectorized host encode (lon, lat, offset-in-bin) -> z (uint64)."""
        nx = self.lon.normalize(x).astype(np.uint64)
        ny = self.lat.normalize(y).astype(np.uint64)
        nt = self.time.normalize(t).astype(np.uint64)
        return zorder.encode_3d_np(nx, ny, nt)

    def index_hi_lo(self, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor):
        """Encode on the tensors' device to the (hi, lo) uint32 key words,
        quantizing in float64 (``normalize_t``): bit for bit the host
        :meth:`index`."""
        return zorder.encode_3d_hi_lo_t(
            self.lon.normalize_t(x), self.lat.normalize_t(y), self.time.normalize_t(t)
        )
