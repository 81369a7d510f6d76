"""Mergeable stat sketches.

Copy of ``geomesa_tpu/stats/sketches.py`` trimmed to the stats the
resident index reduces on the device: ``CountStat``, ``MinMax`` and the
fixed-bin ``Histogram`` (``Stat``, ``CountStat``, ``MinMax`` from
``:65-145``, ``Histogram`` from ``:287-345``), each with ``observe``,
``merge`` and ``to_json``. Vectorized ``observe(values)`` over numpy
columns; ``merge`` folds partials.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class Stat:
    """Base: observe / merge / json."""

    def observe(self, values: np.ndarray) -> None:  # pragma: no cover
        raise NotImplementedError

    def merge(self, other: "Stat") -> "Stat":  # pragma: no cover
        raise NotImplementedError

    def to_json(self) -> dict:  # pragma: no cover
        raise NotImplementedError


@dataclass
class CountStat(Stat):
    count: int = 0

    def observe(self, values):
        self.count += len(values)

    def merge(self, other):
        self.count += other.count
        return self

    def to_json(self):
        return {"type": "count", "count": self.count}


@dataclass
class MinMax(Stat):
    attr: str
    min: "float | None" = None
    max: "float | None" = None
    count: int = 0

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        self.count += len(v)
        lo, hi = v.min(), v.max()
        lo = lo.item() if hasattr(lo, "item") else lo
        hi = hi.item() if hasattr(hi, "item") else hi
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def merge(self, other):
        if other.min is not None:
            self.observe(np.array([other.min, other.max]))
            self.count += other.count - 2
        return self

    def to_json(self):
        return {
            "type": "minmax",
            "attr": self.attr,
            "min": self.min,
            "max": self.max,
            "count": self.count,
        }


@dataclass
class Histogram(Stat):
    """Fixed-bin histogram over [lo, hi]; values outside clip into the end
    bins."""

    attr: str
    bins: int
    lo: float
    hi: float
    counts: np.ndarray = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.bins, dtype=np.int64)

    def bin_of(self, values):
        v = np.asarray(values, dtype=np.float64)
        scale = self.bins / (self.hi - self.lo) if self.hi > self.lo else 0.0
        idx = np.floor((v - self.lo) * scale).astype(np.int64)
        return np.clip(idx, 0, self.bins - 1)

    def observe(self, values):
        v = np.asarray(values)
        if len(v) == 0:
            return
        np.add.at(self.counts, self.bin_of(v), 1)

    def merge(self, other):
        self.counts += other.counts
        return self

    def to_json(self):
        return {
            "type": "histogram",
            "attr": self.attr,
            "bins": self.bins,
            "lo": self.lo,
            "hi": self.hi,
            "counts": self.counts.tolist(),
        }
