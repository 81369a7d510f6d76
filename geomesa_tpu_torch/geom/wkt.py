"""Minimal WKT reader for ECQL geometry literals.

Copy of ``geomesa_tpu/geom/wkt.py`` (reader half). Supports POINT,
LINESTRING, POLYGON, MULTIPOINT, MULTILINESTRING, MULTIPOLYGON and
GeoTools' ENVELOPE(x1, x2, y1, y2) extension (argument order xmin, xmax,
ymin, ymax).
"""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.geom.base import (
    Envelope,
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)

_TOKEN = re.compile(r"\s*([A-Za-z]+|\(|\)|,|-?\d+\.?\d*(?:[eE][-+]?\d+)?)")


class _Tokens:
    def __init__(self, s: str):
        self.toks = _TOKEN.findall(s)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of WKT")
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ValueError(f"expected {t!r}, got {got!r}")


def _number(tk: _Tokens) -> float:
    return float(tk.next())


def _coord_seq(tk: _Tokens) -> np.ndarray:
    tk.expect("(")
    coords = []
    while True:
        x = _number(tk)
        y = _number(tk)
        coords.append((x, y))
        t = tk.next()
        if t == ")":
            break
        if t != ",":
            raise ValueError(f"bad coordinate separator {t!r}")
    return np.array(coords, dtype=np.float64)


def _rings(tk: _Tokens) -> list[np.ndarray]:
    tk.expect("(")
    rings = [_coord_seq(tk)]
    while tk.peek() == ",":
        tk.next()
        rings.append(_coord_seq(tk))
    tk.expect(")")
    return rings


def parse_wkt(s: str) -> Geometry | Envelope:
    tk = _Tokens(s)
    tag = tk.next().upper()
    if tag == "POINT":
        c = _coord_seq(tk)
        return Point(float(c[0, 0]), float(c[0, 1]))
    if tag == "LINESTRING":
        return LineString(_coord_seq(tk))
    if tag == "POLYGON":
        rings = _rings(tk)
        return Polygon(rings[0], tuple(rings[1:]))
    if tag == "MULTIPOINT":
        # both MULTIPOINT(1 2, 3 4) and MULTIPOINT((1 2), (3 4)) appear
        tk.expect("(")
        pts = []
        while True:
            if tk.peek() == "(":
                c = _coord_seq(tk)
                pts.append(Point(float(c[0, 0]), float(c[0, 1])))
            else:
                pts.append(Point(_number(tk), _number(tk)))
            t = tk.next()
            if t == ")":
                break
            if t != ",":
                raise ValueError(f"bad separator {t!r}")
        return MultiPoint(tuple(pts))
    if tag == "MULTILINESTRING":
        return MultiLineString(tuple(LineString(r) for r in _rings(tk)))
    if tag == "MULTIPOLYGON":
        tk.expect("(")
        r = _rings(tk)
        polys = [Polygon(r[0], tuple(r[1:]))]
        while tk.peek() == ",":
            tk.next()
            r = _rings(tk)
            polys.append(Polygon(r[0], tuple(r[1:])))
        tk.expect(")")
        return MultiPolygon(tuple(polys))
    if tag == "ENVELOPE":
        tk.expect("(")
        x1 = _number(tk)
        tk.expect(",")
        x2 = _number(tk)
        tk.expect(",")
        y1 = _number(tk)
        tk.expect(",")
        y2 = _number(tk)
        tk.expect(")")
        return Envelope(x1, y1, x2, y2)
    raise ValueError(f"unsupported WKT type {tag!r}")
