"""Capacity ladder for padded query shapes.

Counterpart of ``geomesa_tpu/bucketing.py`` with the default ladder fixed
(growth 2.0, floor 1) and no conf lookup: ``bucket_cap`` is the next power
of two. The dim-scan query vector pads its time ranges onto this ladder so
that the kernels see R in {1, 2, 4, 8}, and a fused group pads its query
count onto it; ``ladder`` lists the rungs up to a limit (the scheduler's
fusion widths up to ``sched.max.fusion``).
"""

from __future__ import annotations


def bucket_cap(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor, 1)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def ladder(limit: int, floor: int = 1) -> "list[int]":
    """Every rung in [floor, bucket_cap(limit)]: ``floor``, then doubling
    until the limit is reached."""
    limit = max(int(limit), 1)
    v = max(int(floor), 1)
    out = [v]
    while v < limit:
        v *= 2
        out.append(v)
    return out
