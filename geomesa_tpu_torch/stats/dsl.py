"""The Stat DSL: string specs -> sketch instances.

Copy of ``geomesa_tpu/stats/dsl.py`` (ref: geomesa-utils Stat.scala's
parser). Supported:

    Count()
    MinMax("attr")
    Cardinality("attr")
    TopK("attr"[,k])
    Frequency("attr")
    Histogram("attr",bins,lo,hi)
    Z3Histogram("geom","dtg"[,"week"])

Multiple stats combine with ';' into a SeqStat.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.stats.sketches import (
    Cardinality,
    CountStat,
    Frequency,
    Histogram,
    MinMax,
    Stat,
    TopK,
    Z3HistogramStat,
)

_CALL = re.compile(r"^\s*(\w+)\s*\((.*)\)\s*$")


@dataclass
class SeqStat(Stat):
    stats: list

    def observe_batch(self, batch) -> None:
        for s in self.stats:
            _observe_on_batch(s, batch)

    def merge(self, other: "SeqStat"):
        for a, b in zip(self.stats, other.stats):
            a.merge(b)
        return self

    def to_json(self):
        return [s.to_json() for s in self.stats]


def _args(argstr: str) -> list:
    out = []
    for part in filter(None, (p.strip() for p in argstr.split(","))):
        if part.startswith('"') or part.startswith("'"):
            out.append(part[1:-1])
        elif "." in part or "e" in part.lower():
            out.append(float(part))
        else:
            out.append(int(part))
    return out


def parse_stat(spec: str) -> SeqStat:
    stats: list[Stat] = []
    for piece in filter(None, (p.strip() for p in spec.split(";"))):
        m = _CALL.match(piece)
        if not m:
            raise ValueError(f"bad stat spec {piece!r}")
        name, args = m.group(1).lower(), _args(m.group(2))
        if name == "count":
            stats.append(CountStat())
        elif name == "minmax":
            stats.append(MinMax(args[0]))
        elif name == "cardinality":
            stats.append(Cardinality(args[0]))
        elif name == "topk":
            stats.append(TopK(args[0], *([int(args[1])] if len(args) > 1 else [])))
        elif name == "frequency":
            stats.append(Frequency(args[0]))
        elif name == "histogram":
            stats.append(Histogram(args[0], int(args[1]), float(args[2]), float(args[3])))
        elif name == "z3histogram":
            stats.append(
                Z3HistogramStat(args[0], args[1], args[2] if len(args) > 2 else "week")
            )
        else:
            raise ValueError(f"unknown stat {name!r}")
    return SeqStat(stats)


def _observe_on_batch(stat: Stat, batch) -> None:
    """Feed a FeatureBatch into a sketch, resolving attribute columns."""
    if isinstance(stat, CountStat):
        stat.observe(np.empty(len(batch)))
        return
    if isinstance(stat, Z3HistogramStat):
        x, y = batch.point_coords(stat.geom_attr)
        stat.observe_xyt(x, y, batch.column(stat.dtg_attr))
        return
    attr = getattr(stat, "attr", None)
    if attr is None:  # pragma: no cover
        raise TypeError(f"cannot route batch into {type(stat)}")
    desc = batch.sft.descriptor(attr)
    if desc.is_point:
        x, y = batch.point_coords(attr)
        stat.observe(x)  # convention: point stats observe longitude
    else:
        stat.observe(batch.column(attr))
