"""The Stat DSL: string specs -> sketch instances.

Copy of ``geomesa_tpu/stats/dsl.py`` trimmed to the stats the resident
index serves in this slice:

    Count()
    MinMax("attr")
    Histogram("attr",bins,lo,hi)

combined with ';' into a SeqStat. ``Cardinality``, ``TopK``,
``Frequency`` and ``Z3Histogram`` are valid specs of the counterpart that
the port does not have yet: they raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.stats.sketches import CountStat, Histogram, MinMax, Stat

_CALL = re.compile(r"^\s*(\w+)\s*\((.*)\)\s*$")
_LATER = ("cardinality", "topk", "frequency", "z3histogram")


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
        elif name == "histogram":
            stats.append(Histogram(args[0], int(args[1]), float(args[2]), float(args[3])))
        elif name in _LATER:
            raise NotImplementedError(
                f"stat {m.group(1)}: not in the port yet: ROADMAP, port "
                "queue: the store path, host sketches and the server seam"
            )
        else:
            raise ValueError(f"unknown stat {name!r}")
    return SeqStat(stats)


def _observe_on_batch(stat: Stat, batch) -> None:
    """Feed a FeatureBatch into a sketch, resolving attribute columns."""
    if isinstance(stat, CountStat):
        stat.observe(np.empty(len(batch)))
        return
    desc = batch.sft.descriptor(stat.attr)
    if desc.is_point:
        x, _ = batch.point_coords(stat.attr)
        stat.observe(x)  # convention: point stats observe longitude
    else:
        stat.observe(batch.column(stat.attr))
