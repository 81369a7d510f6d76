"""XZ2 curve: lon/lat bounding boxes -> sequence codes.

Copy of ``geomesa_tpu/curves/xz2.py`` (GeoMesa's XZ2SFC): geometry
envelopes normalized to the unit square over lon [-180, 180] x lat
[-90, 90], XZ-encoded at resolution ``g`` (default 12).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geomesa_tpu_torch.curves.xz import (
    DEFAULT_MAX_RANGES,
    DEFAULT_XZ_PRECISION,
    XZSFC,
    IndexRange,
    stack_windows,
)


@dataclass(frozen=True)
class XZ2SFC:
    g: int = DEFAULT_XZ_PRECISION
    x_lo: float = -180.0
    x_hi: float = 180.0
    y_lo: float = -90.0
    y_hi: float = 90.0

    @property
    def _xz(self) -> XZSFC:
        return XZSFC(self.g, dims=2)

    def _windows(self, xmin, ymin, xmax, ymax):
        mins = stack_windows([(xmin, self.x_lo, self.x_hi), (ymin, self.y_lo, self.y_hi)])
        maxs = stack_windows([(xmax, self.x_lo, self.x_hi), (ymax, self.y_lo, self.y_hi)])
        return mins, maxs

    def index(self, xmin, ymin, xmax, ymax) -> np.ndarray:
        """Vectorized bbox -> XZ2 code (int64)."""
        mins, maxs = self._windows(xmin, ymin, xmax, ymax)
        return self._xz.index(mins, maxs)

    def index_hi_lo(self, xmin: torch.Tensor, ymin: torch.Tensor,
                    xmax: torch.Tensor, ymax: torch.Tensor):
        """Encode float64 bboxes on their device -> (hi, lo) uint32 XZ2
        code words, bit for bit :meth:`index`."""
        # divide (not multiply by the reciprocal): the host norm01's rounding
        dx = self.x_hi - self.x_lo
        dy = self.y_hi - self.y_lo
        mins = torch.stack([(xmin - self.x_lo) / dx, (ymin - self.y_lo) / dy])
        maxs = torch.stack([(xmax - self.x_lo) / dx, (ymax - self.y_lo) / dy])
        return self._xz.index_hi_lo(mins, maxs)

    def ranges(
        self, xmin, ymin, xmax, ymax, max_ranges: int = DEFAULT_MAX_RANGES
    ) -> "list[IndexRange]":
        """Query bbox(es) -> sorted inclusive code ranges. Scalars (one
        window) or arrays (several, e.g. an antimeridian-split query)."""
        mins, maxs = self._windows(xmin, ymin, xmax, ymax)
        return self._xz.ranges(mins, maxs, max_ranges)
