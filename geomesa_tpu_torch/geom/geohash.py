"""GeoHash encode/decode.

Copy of ``geomesa_tpu/geom/geohash.py`` (``encode`` ``:20``, ``decode_bbox``
``:62``, ``neighbors`` ``:90``, ``bbox_geohashes`` ``:117``; ref: geomesa-utils
geohash -- the GeoHash class, the base-32 text codec, bbox coverage
helpers).

A geohash is an interleaved lon/lat binary prefix rendered in base-32 --
the same bit-interleave family as the Z2 curve (curves/zorder.py).
Encoding is vectorized over numpy arrays; decode returns the cell center
plus error bounds like the reference.
"""

from __future__ import annotations

import numpy as np

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_DECODE = {c: i for i, c in enumerate(_BASE32)}


def encode(lon, lat, precision: int = 9):
    """Vectorized geohash of (lon, lat) -> array of strings (or one str
    for scalars) at the given character precision (5 bits/char)."""
    scalar = np.isscalar(lon) and np.isscalar(lat)
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    nbits = precision * 5
    lon_bits = (nbits + 1) // 2  # even bit positions start with lon
    lat_bits = nbits // 2
    # quantize each dimension to its bit budget
    qlon = _quantize(lon, -180.0, 180.0, lon_bits)
    qlat = _quantize(lat, -90.0, 90.0, lat_bits)
    # interleave: lon gets bits 0,2,4.. (msb-first), lat 1,3,5..
    z = np.zeros(len(lon), dtype=np.uint64)
    for i in range(lon_bits):
        bit = (qlon >> np.uint64(lon_bits - 1 - i)) & np.uint64(1)
        z |= bit << np.uint64(nbits - 1 - 2 * i)
    for i in range(lat_bits):
        bit = (qlat >> np.uint64(lat_bits - 1 - i)) & np.uint64(1)
        z |= bit << np.uint64(nbits - 2 - 2 * i)
    out = np.empty(len(lon), dtype=object)
    for j in range(len(lon)):
        v = int(z[j])
        out[j] = "".join(
            _BASE32[(v >> (nbits - 5 * (k + 1))) & 31] for k in range(precision)
        )
    return out[0] if scalar else out


def _quantize(v: np.ndarray, lo: float, hi: float, bits: int) -> np.ndarray:
    n = np.uint64(1) << np.uint64(bits)
    frac = (np.clip(v, lo, hi) - lo) / (hi - lo)
    q = np.floor(frac * float(n)).astype(np.uint64)
    return np.minimum(q, n - np.uint64(1))


def decode(gh: str):
    """geohash -> (lon, lat) cell center."""
    (lon0, lon1), (lat0, lat1) = decode_bbox(gh)
    return (lon0 + lon1) / 2.0, (lat0 + lat1) / 2.0


def decode_bbox(gh: str):
    """geohash -> ((lonmin, lonmax), (latmin, latmax)) cell bounds."""
    lon0, lon1 = -180.0, 180.0
    lat0, lat1 = -90.0, 90.0
    even = True
    for c in gh.lower():
        try:
            v = _DECODE[c]
        except KeyError:
            raise ValueError(f"invalid geohash character {c!r}") from None
        for k in range(4, -1, -1):
            bit = (v >> k) & 1
            if even:
                mid = (lon0 + lon1) / 2.0
                if bit:
                    lon0 = mid
                else:
                    lon1 = mid
            else:
                mid = (lat0 + lat1) / 2.0
                if bit:
                    lat0 = mid
                else:
                    lat1 = mid
            even = not even
    return (lon0, lon1), (lat0, lat1)


def neighbors(gh: str) -> list:
    """The 8 adjacent cells (clamped at the poles, wrapped at the
    antimeridian), excluding gh itself."""
    (lon0, lon1), (lat0, lat1) = decode_bbox(gh)
    dlon = lon1 - lon0
    dlat = lat1 - lat0
    clon = (lon0 + lon1) / 2.0
    clat = (lat0 + lat1) / 2.0
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            lat = clat + dy * dlat
            if not -90.0 <= lat <= 90.0:
                continue
            lon = clon + dx * dlon
            if lon > 180.0:
                lon -= 360.0
            elif lon < -180.0:
                lon += 360.0
            n = encode(lon, lat, precision=len(gh))
            if n != gh and n not in out:
                out.append(n)
    return out


def bbox_geohashes(
    xmin: float, ymin: float, xmax: float, ymax: float, precision: int
) -> list:
    """All geohash cells at ``precision`` intersecting the bbox (ref
    coverage helper used for geohash-keyed lookups); grid-walks cell
    centers so it is exact, not a prefix approximation."""
    (lon0, lon1), (lat0, lat1) = decode_bbox(encode(xmin, ymin, precision))
    dlon = lon1 - lon0
    dlat = lat1 - lat0
    out = []
    lat = (lat0 + lat1) / 2.0
    while lat < ymax + dlat / 2 and lat <= 90.0:
        lon = (lon0 + lon1) / 2.0
        while lon < xmax + dlon / 2 and lon <= 180.0:
            out.append(encode(lon, lat, precision))
            lon += dlon
        lat += dlat
    return out
