"""Query box -> contiguous z-value ranges (litmax/bigmin decomposition).

Copy of ``geomesa_tpu/curves/zranges.py`` (``zranges`` with its
breadth-first budgeted descent, ``_merge``, ``IndexRange``), the Python
path only: the counterpart's optional native C++ implementation is
bit-identical to it by contract and is not copied. Given inclusive
per-dimension index bounds, emit sorted disjoint ``[zlo, zhi]`` ranges
whose union covers every z whose cell lies inside the box, over-covering
(never under-covering) when the ``max_ranges`` budget or the recursion
cap is hit. Over-coverage is corrected downstream by the exact
per-feature predicate scan, so result sets do not depend on tightness,
only scan efficiency does.

Binary descent over z bits (MSB first): in Morton layout bit ``p`` of z
belongs to dimension ``p % dims``, so a binary tree over z bits is the
quad/oct tree.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

DEFAULT_MAX_RANGES = 2000  # ref: geomesa.scan.ranges.target default


class IndexRange(NamedTuple):
    lower: int  # inclusive
    upper: int  # inclusive
    contained: bool  # cell fully inside the query box (no residual needed)


def zranges(
    qlo: Sequence[int],
    qhi: Sequence[int],
    bits_per_dim: int,
    max_ranges: int = DEFAULT_MAX_RANGES,
    max_recurse: int | None = None,
) -> list[IndexRange]:
    """Decompose the inclusive box [qlo, qhi] into z ranges.

    qlo/qhi: per-dimension inclusive normalized index bounds (dim order =
    Morton bit order: dim d owns z bits ``k*dims + d``).
    """
    dims = len(qlo)
    if len(qhi) != dims:
        raise ValueError(f"qlo has {dims} dims but qhi has {len(qhi)}")
    total_bits = dims * bits_per_dim
    # coerce + clamp (a negative bound would wrap under a uint64 key)
    max_idx = (1 << bits_per_dim) - 1
    qlo = [min(max(int(v), 0), max_idx) for v in qlo]
    qhi = [min(max(int(v), 0), max_idx) for v in qhi]
    for d in range(dims):
        if qhi[d] < qlo[d]:
            return []
    max_bits = total_bits
    if max_recurse is not None:
        max_bits = _max_bits_for(qlo, qhi, dims, bits_per_dim, max_recurse)

    from collections import deque

    results: list[IndexRange] = []
    overflow: list[IndexRange] = []
    # node: (zprefix, decided_bits, per-dim prefixes tuple). Level-order BFS
    # so the max_ranges budget is spent evenly across the tree -- a DFS would
    # refine one flank to full depth and emit coarse cells for the rest.
    stack: deque[tuple[int, int, tuple[int, ...]]] = deque([(0, 0, (0,) * dims)])

    while stack:
        zprefix, decided, dprefix = stack.popleft()
        rem = total_bits - decided
        # per-dim cell bounds
        contained = True
        disjoint = False
        for d in range(dims):
            # dim d has had ceil/floor share of decided bits: bits of dim d
            # decided so far = number of p < decided with p % dims == d,
            # where p counts from MSB: p-th decided bit is z bit
            # (total_bits - 1 - p), owning dim (total_bits - 1 - p) % dims.
            dec_d = _decided_for_dim(decided, d, dims, total_bits)
            r = bits_per_dim - dec_d
            lo_d = dprefix[d] << r
            hi_d = lo_d + (1 << r) - 1
            if hi_d < qlo[d] or lo_d > qhi[d]:
                disjoint = True
                break
            if not (lo_d >= qlo[d] and hi_d <= qhi[d]):
                contained = False
        if disjoint:
            continue
        zlo = zprefix << rem
        zhi = zlo + (1 << rem) - 1
        if contained:
            results.append(IndexRange(zlo, zhi, True))
            continue
        budget_left = max_ranges - len(results) - len(overflow) - len(stack)
        if rem == 0 or decided >= max_bits or budget_left <= 0:
            overflow.append(IndexRange(zlo, zhi, False))
            continue
        # split on the next z bit (MSB-first): z bit index total_bits-1-decided
        d = (total_bits - 1 - decided) % dims
        new_dp1 = tuple(
            (v << 1) | 1 if i == d else v for i, v in enumerate(dprefix)
        )
        new_dp0 = tuple((v << 1) if i == d else v for i, v in enumerate(dprefix))
        stack.append((zprefix << 1, decided + 1, new_dp0))
        stack.append(((zprefix << 1) | 1, decided + 1, new_dp1))
    results.extend(overflow)
    results.sort(key=lambda r: r.lower)
    return _merge(results, max_ranges)


def _max_bits_for(qlo, qhi, dims: int, bits_per_dim: int, max_recurse: int) -> int:
    """Depth cap: common z-prefix of the box corners + max_recurse rounds."""
    total_bits = dims * bits_per_dim
    zmin = _encode_py(tuple(int(v) for v in qlo), bits_per_dim)
    zmax = _encode_py(tuple(int(v) for v in qhi), bits_per_dim)
    diff = zmin ^ zmax
    prefix_len = total_bits - diff.bit_length()
    return min(total_bits, prefix_len + max_recurse * dims)


def _decided_for_dim(decided: int, d: int, dims: int, total_bits: int) -> int:
    """How many bits of dim d are fixed after `decided` MSB-first z bits."""
    # z bits consumed: total_bits-1 down to total_bits-decided.
    # bit index b owns dim b % dims; count b in [total_bits-decided, total_bits-1]
    # with b % dims == d.
    if decided == 0:
        return 0
    lo_b = total_bits - decided
    hi_b = total_bits - 1
    # count of integers in [lo_b, hi_b] congruent to d mod dims
    return (hi_b - d) // dims - (lo_b - 1 - d) // dims if hi_b >= d else 0


def _merge(ranges: list[IndexRange], max_ranges: int) -> list[IndexRange]:
    """Coalesce adjacent/overlapping ranges; enforce the budget by merging
    the smallest gaps (over-covering, marked not-contained)."""
    if not ranges:
        return ranges
    merged: list[IndexRange] = []
    cur = ranges[0]
    for r in ranges[1:]:
        if r.lower <= cur.upper + 1:
            cur = IndexRange(
                cur.lower, max(cur.upper, r.upper), cur.contained and r.contained
            )
        else:
            merged.append(cur)
            cur = r
    merged.append(cur)
    while len(merged) > max_ranges:
        # merge the pair with the smallest gap
        gaps = [
            (merged[i + 1].lower - merged[i].upper, i)
            for i in range(len(merged) - 1)
        ]
        _, i = min(gaps)
        merged[i : i + 2] = [
            IndexRange(merged[i].lower, merged[i + 1].upper, False)
        ]
    return merged


def _encode_py(coords: "tuple[int, ...]", bits: int) -> int:
    """Bit-by-bit Morton interleave: coords[d] contributes bit d of each
    ``dims``-bit group (the counterpart's ``zorder.encode_py``)."""
    dims = len(coords)
    z = 0
    for k in range(bits):
        for d, c in enumerate(coords):
            z |= ((c >> k) & 1) << (k * dims + d)
    return z
