"""Filter expression tree.

Copy of ``geomesa_tpu/filter/ast.py``. Temporal literals are epoch
milliseconds; geometries are ``geomesa_tpu_torch.geom`` values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from geomesa_tpu_torch.geom import Envelope, Geometry


class Filter:
    def __and__(self, other: "Filter") -> "Filter":
        return And((self, other))

    def __or__(self, other: "Filter") -> "Filter":
        return Or((self, other))

    def __invert__(self) -> "Filter":
        return Not(self)


@dataclass(frozen=True)
class _Include(Filter):
    def __repr__(self):
        return "INCLUDE"


@dataclass(frozen=True)
class _Exclude(Filter):
    def __repr__(self):
        return "EXCLUDE"


Include = _Include()
Exclude = _Exclude()


@dataclass(frozen=True)
class And(Filter):
    children: tuple

    def __init__(self, children: Sequence[Filter]):
        flat = []
        for c in children:
            if isinstance(c, And):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))


@dataclass(frozen=True)
class Or(Filter):
    children: tuple

    def __init__(self, children: Sequence[Filter]):
        flat = []
        for c in children:
            if isinstance(c, Or):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))


@dataclass(frozen=True)
class Not(Filter):
    child: Filter


@dataclass(frozen=True)
class BBox(Filter):
    attr: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    def __post_init__(self):
        # plain Python floats: the kernel constant encoder rounds each
        # bound to float32 exactly once
        for f in ("xmin", "ymin", "xmax", "ymax"):
            object.__setattr__(self, f, float(getattr(self, f)))

    @property
    def envelope(self) -> Envelope:
        return Envelope(self.xmin, self.ymin, self.xmax, self.ymax)


@dataclass(frozen=True)
class Intersects(Filter):
    """Geometry relation predicate (op records the original verb; WITHIN =
    data within query geometry). ``pattern`` carries the DE-9IM mask for
    op='relate'."""

    attr: str
    geometry: Geometry
    # intersects | within | contains | disjoint | crosses | touches |
    # overlaps | equals | relate
    op: str = "intersects"
    pattern: "str | None" = None


@dataclass(frozen=True)
class DWithin(Filter):
    """Distance-within (degrees; units are converted at parse time)."""

    attr: str
    geometry: Geometry
    distance: float

    def __post_init__(self):
        object.__setattr__(self, "distance", float(self.distance))


@dataclass(frozen=True)
class During(Filter):
    """t in [t0, t1] (ms), inclusive at ms resolution as GeoMesa's planner
    treats intervals; ``exclusive`` records the original form."""

    attr: str
    t0: int
    t1: int
    exclusive: bool = False


@dataclass(frozen=True)
class Compare(Filter):
    """attr <op> literal; op in =, <>, <, <=, >, >=."""

    op: str
    attr: str
    value: Any


@dataclass(frozen=True)
class Between(Filter):
    attr: str
    lo: Any
    hi: Any


@dataclass(frozen=True)
class In(Filter):
    attr: str
    values: tuple


@dataclass(frozen=True)
class Like(Filter):
    attr: str
    pattern: str  # SQL LIKE: % and _

    def regex(self) -> str:
        import re as _re

        out = []
        for ch in self.pattern:
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(_re.escape(ch))
        return "^" + "".join(out) + "$"


@dataclass(frozen=True)
class IsNull(Filter):
    attr: str
    negate: bool = False


def attributes_of(f: Filter) -> set:
    """All attribute names referenced by a filter."""
    if isinstance(f, (And, Or)):
        out: set = set()
        for c in f.children:
            out |= attributes_of(c)
        return out
    if isinstance(f, Not):
        return attributes_of(f.child)
    attr = getattr(f, "attr", None)
    return {attr} if attr else set()
