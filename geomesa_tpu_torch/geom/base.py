"""Geometry value types: immutable, numpy-backed coordinate arrays.

Copy of ``geomesa_tpu/geom/base.py``: envelopes with their set
operations, and the geometry kinds with their parts (``points``,
``lines``, ``polygons``) and rings (``Polygon.rings``,
``MultiPolygon.rings``) that the host predicates walk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Envelope:
    """Axis-aligned bounding box (inclusive)."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    def intersects(self, other: "Envelope") -> bool:
        return not (
            other.xmin > self.xmax
            or other.xmax < self.xmin
            or other.ymin > self.ymax
            or other.ymax < self.ymin
        )

    def contains_env(self, other: "Envelope") -> bool:
        return (
            self.xmin <= other.xmin
            and self.xmax >= other.xmax
            and self.ymin <= other.ymin
            and self.ymax >= other.ymax
        )

    def intersection(self, other: "Envelope") -> "Envelope | None":
        xmin, xmax = max(self.xmin, other.xmin), min(self.xmax, other.xmax)
        ymin, ymax = max(self.ymin, other.ymin), min(self.ymax, other.ymax)
        if xmin > xmax or ymin > ymax:
            return None
        return Envelope(xmin, ymin, xmax, ymax)

    def expand(self, other: "Envelope") -> "Envelope":
        return Envelope(
            min(self.xmin, other.xmin),
            min(self.ymin, other.ymin),
            max(self.xmax, other.xmax),
            max(self.ymax, other.ymax),
        )

    @staticmethod
    def world() -> "Envelope":
        return Envelope(-180.0, -90.0, 180.0, 90.0)


class Geometry:
    """Base class; subclasses expose ``envelope`` and coordinate arrays."""

    @property
    def envelope(self) -> Envelope:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class Point(Geometry):
    x: float
    y: float

    @property
    def envelope(self) -> Envelope:
        return Envelope(self.x, self.y, self.x, self.y)


def _coords_array(coords) -> np.ndarray:
    a = np.asarray(coords, dtype=np.float64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"expected (n, 2) coordinates, got {a.shape}")
    return a


def _coords_envelope(c: np.ndarray) -> Envelope:
    lo, hi = c.min(axis=0), c.max(axis=0)  # two reductions, not four
    return Envelope(lo[0], lo[1], hi[0], hi[1])


@dataclass(frozen=True)
class LineString(Geometry):
    coords: np.ndarray  # (n, 2)

    def __post_init__(self):
        object.__setattr__(self, "coords", _coords_array(self.coords))

    @property
    def envelope(self) -> Envelope:
        return _coords_envelope(self.coords)


@dataclass(frozen=True)
class Polygon(Geometry):
    """Exterior shell plus optional interior rings (holes). Rings are closed
    (first == last coordinate) per WKT convention."""

    shell: np.ndarray  # (n, 2)
    holes: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "shell", _coords_array(self.shell))
        object.__setattr__(
            self, "holes", tuple(_coords_array(h) for h in self.holes)
        )

    @property
    def envelope(self) -> Envelope:
        return _coords_envelope(self.shell)

    def rings(self):
        return (self.shell, *self.holes)


def _union_envelope(parts) -> Envelope:
    e = parts[0].envelope
    for p in parts[1:]:
        e = e.expand(p.envelope)
    return e


@dataclass(frozen=True)
class MultiPoint(Geometry):
    points: tuple

    @property
    def envelope(self) -> Envelope:
        return _union_envelope(self.points)


@dataclass(frozen=True)
class MultiLineString(Geometry):
    lines: tuple

    @property
    def envelope(self) -> Envelope:
        return _union_envelope(self.lines)


@dataclass(frozen=True)
class MultiPolygon(Geometry):
    polygons: tuple

    @property
    def envelope(self) -> Envelope:
        return _union_envelope(self.polygons)

    def rings(self):
        out = []
        for p in self.polygons:
            out.extend(p.rings())
        return tuple(out)
