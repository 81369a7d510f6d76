"""Capacity ladder for padded query shapes.

Counterpart of ``geomesa_tpu/bucketing.py`` with the default ladder fixed
(growth 2.0, floor 1) and no conf lookup: ``bucket_cap`` is the next power
of two. The dim-scan query vector pads its time ranges onto this ladder so
that the kernels see R in {1, 2, 4, 8}.
"""

from __future__ import annotations


def bucket_cap(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor, 1)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()
