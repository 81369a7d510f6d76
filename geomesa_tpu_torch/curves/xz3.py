"""XZ3 curve: lon/lat/time bounding boxes -> sequence codes within a bin.

Copy of ``geomesa_tpu/curves/xz3.py`` (GeoMesa's XZ3SFC): the spatial
bbox plus the time extent within one BinnedTime period, normalized to the
unit cube and XZ-encoded at resolution ``g`` (default 12) over an octree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset
from geomesa_tpu_torch.curves.xz import (
    DEFAULT_MAX_RANGES,
    DEFAULT_XZ_PRECISION,
    XZSFC,
    IndexRange,
    stack_windows,
)


@dataclass(frozen=True)
class XZ3SFC:
    period: TimePeriod = TimePeriod.WEEK
    g: int = DEFAULT_XZ_PRECISION

    @property
    def _xz(self) -> XZSFC:
        return XZSFC(self.g, dims=3)

    @property
    def t_max(self) -> float:
        return float(max_offset(self.period))

    def _windows(self, xmin, ymin, tmin, xmax, ymax, tmax):
        mins = stack_windows(
            [(xmin, -180.0, 180.0), (ymin, -90.0, 90.0), (tmin, 0.0, self.t_max)]
        )
        maxs = stack_windows(
            [(xmax, -180.0, 180.0), (ymax, -90.0, 90.0), (tmax, 0.0, self.t_max)]
        )
        return mins, maxs

    def index(self, xmin, ymin, tmin, xmax, ymax, tmax) -> np.ndarray:
        """Vectorized (bbox, time-offsets-in-bin) -> XZ3 code (int64)."""
        mins, maxs = self._windows(xmin, ymin, tmin, xmax, ymax, tmax)
        return self._xz.index(mins, maxs)

    def index_hi_lo(self, xmin, ymin, tmin, xmax, ymax, tmax):
        """Encode float64 (bbox, offsets) tensors on their device -> (hi,
        lo) uint32 XZ3 code words, bit for bit :meth:`index`."""
        # divide (not multiply by the reciprocal): the host norm01's rounding
        mins = torch.stack([(xmin + 180.0) / 360.0, (ymin + 90.0) / 180.0, tmin / self.t_max])
        maxs = torch.stack([(xmax + 180.0) / 360.0, (ymax + 90.0) / 180.0, tmax / self.t_max])
        return self._xz.index_hi_lo(mins, maxs)

    def ranges(
        self, xmin, ymin, tmin, xmax, ymax, tmax, max_ranges: int = DEFAULT_MAX_RANGES
    ) -> "list[IndexRange]":
        mins, maxs = self._windows(xmin, ymin, tmin, xmax, ymax, tmax)
        return self._xz.ranges(mins, maxs, max_ranges)
