"""Z2 space-filling curve dimensions: (lon, lat).

Copy of ``geomesa_tpu/curves/z2.py``, trimmed to the sfc's dimensions:
31-bit quantization of lon in [-180, 180] and lat in [-90, 90].
"""

from __future__ import annotations

from dataclasses import dataclass

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
