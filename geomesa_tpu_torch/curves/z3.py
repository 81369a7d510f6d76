"""Z3 space-filling curve dimensions: (lon, lat, time-offset).

Copy of ``geomesa_tpu/curves/z3.py``, trimmed to the sfc's dimensions and
period (the slice scans de-interleaved key planes, so it needs neither the
Morton interleave nor the z-range planner). 21-bit quantization of lon/lat
and of the time offset within a ``BinnedTime`` period (week by default).
"""

from __future__ import annotations

from dataclasses import dataclass

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
