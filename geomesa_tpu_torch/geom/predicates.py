"""Point-in-polygon helpers for the slice.

Copy of the parts of ``geomesa_tpu/geom/predicates.py`` the port uses:
``polygon_edges`` (the edge packing every crossing test shares), the host
crossing-number test (the exact oracle of ``evaluate_host``), and the
DE-9IM pattern check the ECQL parser runs. Boundary behavior follows the
half-open rule: a vertex counts for the edge whose y-interval is
[min, max).
"""

from __future__ import annotations

import numpy as np


def polygon_edges(rings) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack closed rings into edge arrays (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = [], [], [], []
    for ring in rings:
        r = np.asarray(ring, dtype=np.float64)
        a = r[:-1]
        b = r[1:]
        x1.append(a[:, 0])
        y1.append(a[:, 1])
        x2.append(b[:, 0])
        y2.append(b[:, 1])
    return (
        np.concatenate(x1),
        np.concatenate(y1),
        np.concatenate(x2),
        np.concatenate(y2),
    )


def points_in_polygon(px, py, rings) -> np.ndarray:
    """Crossing-number containment for (n,) point arrays against a polygon
    given as closed rings (shell + holes: odd crossings = inside)."""
    x1, y1, x2, y2 = polygon_edges(rings)
    px = np.asarray(px, dtype=np.float64)[:, None]
    py = np.asarray(py, dtype=np.float64)[:, None]
    # edge straddles the horizontal ray (half-open to dodge vertex double count)
    straddle = (y1[None, :] > py) != (y2[None, :] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
    crossing = straddle & (px < xint)
    return crossing.sum(axis=1) % 2 == 1


def validate_de9im_pattern(pattern: str) -> str:
    """Normalize + validate a DE-9IM pattern (9 chars of ``*TF012``).
    Returns the uppercased pattern; raises ValueError."""
    p = pattern.upper()
    if len(p) != 9 or any(c not in "*TF012" for c in p):
        raise ValueError(
            f"bad DE-9IM pattern {pattern!r} (9 chars of *TF012)"
        )
    return p
