"""WKB + TWKB geometry codecs.

Copy of ``geomesa_tpu/geom/wkb.py`` (``to_wkb`` ``:39``, ``from_wkb`` ``:87``,
``to_twkb`` ``:190``, ``from_twkb`` ``:227``; ref: geomesa-utils WKBUtils and the
Kryo geometry serialization's TWKB-like compact encoding,
KryoGeometrySerialization). The bytes equal the counterpart's.

WKB follows OGC 99-049 (little-endian by default, both orders read).
TWKB is the compact varint format the reference uses inside Kryo values:
zigzag delta-encoded coordinates at a configurable decimal precision --
typically 4-6x smaller than WKB for tracks and polygons.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from geomesa_tpu_torch.geom.base import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)

_WKB_POINT = 1
_WKB_LINESTRING = 2
_WKB_POLYGON = 3
_WKB_MULTIPOINT = 4
_WKB_MULTILINESTRING = 5
_WKB_MULTIPOLYGON = 6


# -- WKB ---------------------------------------------------------------------


def to_wkb(geom: Geometry) -> bytes:
    buf = io.BytesIO()
    _write_wkb(buf, geom)
    return buf.getvalue()


def _write_wkb(buf, geom) -> None:
    buf.write(b"\x01")  # little-endian

    def header(code):
        buf.write(struct.pack("<I", code))

    def coords(arr):
        a = np.asarray(arr, dtype="<f8")
        buf.write(struct.pack("<I", len(a)))
        buf.write(a.tobytes())

    if isinstance(geom, Point):
        header(_WKB_POINT)
        buf.write(struct.pack("<dd", geom.x, geom.y))
    elif isinstance(geom, LineString):
        header(_WKB_LINESTRING)
        coords(geom.coords)
    elif isinstance(geom, Polygon):
        header(_WKB_POLYGON)
        rings = geom.rings()
        buf.write(struct.pack("<I", len(rings)))
        for r in rings:
            coords(r)
    elif isinstance(geom, MultiPoint):
        header(_WKB_MULTIPOINT)
        buf.write(struct.pack("<I", len(geom.points)))
        for p in geom.points:
            _write_wkb(buf, p)
    elif isinstance(geom, MultiLineString):
        header(_WKB_MULTILINESTRING)
        buf.write(struct.pack("<I", len(geom.lines)))
        for l in geom.lines:
            _write_wkb(buf, l)
    elif isinstance(geom, MultiPolygon):
        header(_WKB_MULTIPOLYGON)
        buf.write(struct.pack("<I", len(geom.polygons)))
        for p in geom.polygons:
            _write_wkb(buf, p)
    else:
        raise TypeError(f"cannot WKB-encode {type(geom)}")


def from_wkb(data: "bytes | io.BytesIO") -> Geometry:
    buf = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data
    return _read_wkb(buf)


def _read_wkb(buf) -> Geometry:
    bo = buf.read(1)
    end = "<" if bo == b"\x01" else ">"
    (code,) = struct.unpack(end + "I", buf.read(4))
    code &= 0xFF  # strip EWKB/Z flags

    def ncoords():
        (n,) = struct.unpack(end + "I", buf.read(4))
        a = np.frombuffer(buf.read(16 * n), dtype=end + "f8").reshape(n, 2)
        return a.astype(np.float64)

    if code == _WKB_POINT:
        x, y = struct.unpack(end + "dd", buf.read(16))
        return Point(x, y)
    if code == _WKB_LINESTRING:
        return LineString(ncoords())
    if code == _WKB_POLYGON:
        (n,) = struct.unpack(end + "I", buf.read(4))
        rings = [ncoords() for _ in range(n)]
        return Polygon(rings[0], tuple(rings[1:]))
    (n,) = struct.unpack(end + "I", buf.read(4))
    parts = [_read_wkb(buf) for _ in range(n)]
    if code == _WKB_MULTIPOINT:
        return MultiPoint(tuple(parts))
    if code == _WKB_MULTILINESTRING:
        return MultiLineString(tuple(parts))
    if code == _WKB_MULTIPOLYGON:
        return MultiPolygon(tuple(parts))
    raise ValueError(f"unsupported WKB geometry code {code}")


# -- TWKB --------------------------------------------------------------------


def _zz(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzz(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _wv(buf, n: int) -> None:  # unsigned varint
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _rv(buf) -> int:
    shift = acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return acc
        shift += 7


class _DeltaWriter:
    def __init__(self, buf, scale: float):
        self.buf = buf
        self.scale = scale
        self.px = 0
        self.py = 0

    def write(self, arr) -> None:
        a = np.asarray(arr, dtype=np.float64)
        q = np.round(a * self.scale).astype(np.int64)
        _wv(self.buf, len(q))
        for x, y in q:
            _wv(self.buf, _zz(int(x) - self.px))
            _wv(self.buf, _zz(int(y) - self.py))
            self.px, self.py = int(x), int(y)


class _DeltaReader:
    def __init__(self, buf, scale: float):
        self.buf = buf
        self.scale = scale
        self.px = 0
        self.py = 0

    def read(self) -> np.ndarray:
        n = _rv(self.buf)
        out = np.empty((n, 2), dtype=np.float64)
        for i in range(n):
            self.px += _unzz(_rv(self.buf))
            self.py += _unzz(_rv(self.buf))
            out[i] = (self.px / self.scale, self.py / self.scale)
        return out


def to_twkb(geom: Geometry, precision: int = 7) -> bytes:
    """Compact varint encoding; precision = decimal digits kept (7 ~ cm at
    the equator, the reference's default for Kryo geometry payloads)."""
    buf = io.BytesIO()
    code = {
        Point: _WKB_POINT,
        LineString: _WKB_LINESTRING,
        Polygon: _WKB_POLYGON,
        MultiPoint: _WKB_MULTIPOINT,
        MultiLineString: _WKB_MULTILINESTRING,
        MultiPolygon: _WKB_MULTIPOLYGON,
    }[type(geom)]
    buf.write(bytes([code | (precision << 4)]))
    w = _DeltaWriter(buf, 10.0**precision)
    if isinstance(geom, Point):
        w.write([(geom.x, geom.y)])
    elif isinstance(geom, LineString):
        w.write(geom.coords)
    elif isinstance(geom, Polygon):
        _wv(buf, len(geom.rings()))
        for r in geom.rings():
            w.write(r)
    elif isinstance(geom, MultiPoint):
        w.write([(p.x, p.y) for p in geom.points])
    elif isinstance(geom, MultiLineString):
        _wv(buf, len(geom.lines))
        for l in geom.lines:
            w.write(l.coords)
    else:  # MultiPolygon
        _wv(buf, len(geom.polygons))
        for p in geom.polygons:
            _wv(buf, len(p.rings()))
            for r in p.rings():
                w.write(r)
    return buf.getvalue()


def from_twkb(data: bytes) -> Geometry:
    buf = io.BytesIO(data)
    (head,) = buf.read(1)
    code = head & 0x0F
    precision = head >> 4
    r = _DeltaReader(buf, 10.0**precision)
    if code == _WKB_POINT:
        (xy,) = r.read()
        return Point(float(xy[0]), float(xy[1]))
    if code == _WKB_LINESTRING:
        return LineString(r.read())
    if code == _WKB_POLYGON:
        n = _rv(buf)
        rings = [r.read() for _ in range(n)]
        return Polygon(rings[0], tuple(rings[1:]))
    if code == _WKB_MULTIPOINT:
        pts = r.read()
        return MultiPoint(tuple(Point(float(x), float(y)) for x, y in pts))
    if code == _WKB_MULTILINESTRING:
        n = _rv(buf)
        return MultiLineString(tuple(LineString(r.read()) for _ in range(n)))
    if code == _WKB_MULTIPOLYGON:
        n = _rv(buf)
        polys = []
        for _ in range(n):
            m = _rv(buf)
            rings = [r.read() for _ in range(m)]
            polys.append(Polygon(rings[0], tuple(rings[1:])))
        return MultiPolygon(tuple(polys))
    raise ValueError(f"unsupported TWKB geometry code {code}")
