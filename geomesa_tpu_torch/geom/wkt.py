"""Minimal WKT reader for ECQL geometry literals.

Copy of ``geomesa_tpu/geom/wkt.py``: the reader, and ``to_wkt``, the
writer the file-system store's codec stores non-point geometries with
(10 significant digits, as the counterpart writes them). Supports POINT,
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


def _fmt(v: float) -> str:
    return f"{v:.10g}"


def _seq_wkt(coords: np.ndarray) -> str:
    return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in coords) + ")"


def to_wkt(g) -> str:
    if isinstance(g, Point):
        return f"POINT ({_fmt(g.x)} {_fmt(g.y)})"
    if isinstance(g, LineString):
        return "LINESTRING " + _seq_wkt(g.coords)
    if isinstance(g, Polygon):
        return "POLYGON (" + ", ".join(_seq_wkt(r) for r in g.rings()) + ")"
    if isinstance(g, MultiPoint):
        return "MULTIPOINT (" + ", ".join(f"({_fmt(p.x)} {_fmt(p.y)})" for p in g.points) + ")"
    if isinstance(g, MultiLineString):
        return "MULTILINESTRING (" + ", ".join(_seq_wkt(ln.coords) for ln in g.lines) + ")"
    if isinstance(g, MultiPolygon):
        return "MULTIPOLYGON (" + ", ".join(
            "(" + ", ".join(_seq_wkt(r) for r in p.rings()) + ")" for p in g.polygons
        ) + ")"
    if isinstance(g, Envelope):
        return f"ENVELOPE ({_fmt(g.xmin)}, {_fmt(g.xmax)}, {_fmt(g.ymin)}, {_fmt(g.ymax)})"
    raise TypeError(f"cannot write WKT for {type(g)}")
