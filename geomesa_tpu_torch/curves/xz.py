"""XZ-ordering: space-filling curves for spatial objects with extents.

Copy of ``geomesa_tpu/curves/xz.py`` (the XZ-ordering of Boehm, Klump &
Kriegel as GeoMesa's XZ2SFC/XZ3SFC use it for non-point geometries), with
a torch encode on the card in place of the counterpart's JAX one and
without its native C++ walk.

A bounding box is stored at the resolution level whose *enlarged* cell
(2x the cell extent in every dimension) can hold it, addressed by the
cell of its lower-left corner; a cell at level ``l`` has the code of the
pre-order walk of the quad/oct tree. A query walks the tree: a window
that contains a cell's enlarged extent matches the whole subtree, one
that only intersects it matches the cell's own code and refines its
children.

Generic over dimension count (2: quadtree, 3: octree); XZ2SFC/XZ3SFC wrap
it with lon/lat(/binned-time) normalization.

The card encode (:meth:`XZSFC.index_hi_lo`) runs the level count and the
pre-order walk in float64 tensors and accumulates the code in int64
lanes, which the card has: every code is under 2^63 (g <= 31 in 2-D,
g <= 20 in 3-D), so the counterpart's uint32 hi/lo carry is not needed,
and the words are split off at the end, as ``curves/zorder.py`` does.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from geomesa_tpu_torch.curves.zorder import _hi_lo_t

DEFAULT_XZ_PRECISION = 12  # ref: geomesa.xz.precision default
DEFAULT_MAX_RANGES = 2000  # ref: geomesa.scan.ranges.target default


class IndexRange(NamedTuple):
    """Inclusive code range (counterpart: ``curves/zranges.IndexRange``)."""

    lower: int
    upper: int
    contained: bool  # cell fully inside the query box (no residual needed)


def norm01(v, lo: float, hi: float) -> np.ndarray:
    """Normalize values in [lo, hi] to the unit interval (float64)."""
    return (np.asarray(v, dtype=np.float64) - lo) / (hi - lo)


def stack_windows(dims_lohi: "list[tuple]") -> np.ndarray:
    """Per-dim (value, lo, hi) triples -> (dims, n) normalized array."""
    return np.stack([np.atleast_1d(norm01(v, lo, hi)) for v, lo, hi in dims_lohi])


@dataclass(frozen=True)
class XZSFC:
    """Dimension-generic XZ curve over the unit hypercube [0,1]^dims."""

    g: int  # max resolution (tree depth)
    dims: int

    def __post_init__(self):
        # total code count (fanout^(g+1)-1)/(fanout-1) must fit int64
        limit = {2: 31, 3: 20}.get(self.dims)
        if limit is None:
            raise ValueError(f"unsupported dims {self.dims}")
        if not 1 <= self.g <= limit:
            raise ValueError(
                f"g={self.g} out of range [1, {limit}] for dims={self.dims} "
                "(code space must fit int64)"
            )

    @property
    def fanout(self) -> int:
        return 1 << self.dims  # 4 for 2D, 8 for 3D

    def _child_step(self, level: int) -> int:
        """Pre-order code increment per quadrant unit at ``level`` (the code
        span of one child subtree plus its root):
        (fanout^(g-level) - 1)/(fanout-1). Shared by sequence_code and
        ranges so encode and decompose cannot drift."""
        f = self.fanout
        return (f ** (self.g - level) - 1) // (f - 1)

    def subtree_size(self, level: int) -> int:
        """Number of codes in a full subtree rooted at depth ``level``
        (excluding the root itself): (fanout^(g-level+1) - 1)/(fanout-1) - 1."""
        f = self.fanout
        return (f ** (self.g - level + 1) - 1) // (f - 1) - 1

    # -- encoding ----------------------------------------------------------

    def length(self, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
        """Resolution level at which each normalized box is stored.

        mins/maxs: (dims, n) arrays in [0, 1]. An object lives at level l1 =
        floor(log2(1/maxdim)) unless it also fits a single enlarged cell one
        level finer, in which case l1 + 1. Result clamped to [0, g].
        """
        w = np.maximum.reduce(maxs - mins)  # max extent per object
        # l1 = floor(log2(1/w)) exactly from the float exponent (frexp:
        # w = m * 2^e with m in [0.5, 1)); point boxes go to max depth
        m, e = np.frexp(np.where(w > 0, w, 1.0))
        l1 = np.where(m == 0.5, 1 - e, -e).astype(np.int64)
        l1 = np.where(w <= 0, self.g, np.minimum(l1, self.g))
        # check fit one level deeper: max <= floor(min/w2)*w2 + 2*w2
        w2 = np.power(0.5, np.minimum(l1 + 1, self.g).astype(np.float64))
        fits = np.ones(w.shape, dtype=bool)
        for d in range(self.dims):
            fits &= maxs[d] <= np.floor(mins[d] / w2) * w2 + 2 * w2
        length = np.where((l1 < self.g) & fits, l1 + 1, l1)
        return np.clip(length, 0, self.g)

    def sequence_code(self, point: np.ndarray, length: np.ndarray) -> np.ndarray:
        """Pre-order code of the level-``length`` cell containing ``point``.

        point: (dims, n) in [0,1); length: (n,) levels. Vectorized walk of
        ``g`` steps with per-lane stop at ``length``.
        """
        n = point.shape[1]
        lo = np.zeros((self.dims, n))
        hi = np.ones((self.dims, n))
        cs = np.zeros(n, dtype=np.int64)
        for i in range(self.g):
            active = i < length
            center = (lo + hi) * 0.5
            quad = np.zeros(n, dtype=np.int64)
            for d in range(self.dims):
                quad |= (point[d] >= center[d]).astype(np.int64) << d
            step = 1 + quad * self._child_step(i)
            cs = np.where(active, cs + step, cs)
            upper = (quad[None, :] >> np.arange(self.dims)[:, None]) & 1
            new_lo = np.where(upper == 1, center, lo)
            new_hi = np.where(upper == 1, hi, center)
            lo = np.where(active[None, :], new_lo, lo)
            hi = np.where(active[None, :], new_hi, hi)
        return cs

    def index(self, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
        """Normalized boxes -> XZ sequence codes (int64). (dims, n) arrays.

        Inverted boxes (min > max, e.g. an un-split antimeridian-crossing
        bbox) are rejected: their codes would be ones that range queries
        never cover.
        """
        mins = np.asarray(mins, dtype=np.float64)
        maxs = np.asarray(maxs, dtype=np.float64)
        if np.any(maxs < mins):
            bad = np.nonzero(np.any(maxs < mins, axis=0))[0][:3]
            raise ValueError(
                f"inverted box bounds at rows {bad.tolist()} (min > max); "
                "split antimeridian-crossing geometries before indexing"
            )
        mins = np.clip(mins, 0.0, 1.0)
        maxs = np.clip(maxs, 0.0, 1.0)
        length = self.length(mins, maxs)
        return self.sequence_code(mins, length)

    def _step_table(self) -> np.ndarray:
        """(g, fanout) int64 per-level pre-order code increments
        ``1 + quad * child_step(level)``, which the card walk gathers (the
        counterpart's ``_step_tables`` holds them as uint32 hi/lo words)."""
        f = self.fanout
        return np.array(
            [[1 + q * self._child_step(i) for q in range(f)] for i in range(self.g)],
            dtype=np.int64,
        )

    def index_hi_lo(self, mins: torch.Tensor, maxs: torch.Tensor):
        """Card encode: normalized float64 (dims, n) boxes -> (hi, lo)
        uint32 code words, on the tensors' device; bit for bit
        :meth:`index` (counterpart: ``index_jax_hi_lo``). Inverted boxes
        are clamped to a point box at ``mins`` rather than raised: staging
        feeds only geometry envelopes, which are never inverted."""
        if mins.dtype != torch.float64 or maxs.dtype != torch.float64:
            raise TypeError("the xz encode takes float64 boxes")
        mins = mins.clamp(0.0, 1.0)
        maxs = torch.maximum(maxs.clamp(0.0, 1.0), mins)
        dev = mins.device
        # -- resolution level (mirrors length(), exactly) -------------------
        # min(floor(log2(1/w)), g) is the count of levels l in [1, g] with
        # w <= 2^-l: compares against exact powers of two, so it equals the
        # host's frexp floor bit for bit; w == 0 gives level g
        w = (maxs - mins).amax(dim=0)
        l1 = torch.zeros(w.shape, dtype=torch.int64, device=dev)
        for lv in range(1, self.g + 1):
            l1 += w <= 2.0**-lv
        pow_tbl = torch.from_numpy(np.power(0.5, np.arange(self.g + 1))).to(dev)
        w2 = pow_tbl[torch.clamp(l1 + 1, max=self.g)]
        fits = torch.ones(w.shape, dtype=torch.bool, device=dev)
        for d in range(self.dims):
            fits &= maxs[d] <= torch.floor(mins[d] / w2) * w2 + 2 * w2
        length = torch.where((l1 < self.g) & fits, l1 + 1, l1)
        # -- pre-order walk -------------------------------------------------
        steps = torch.from_numpy(self._step_table()).to(dev)
        point = mins
        lo = torch.zeros_like(point)
        hi = torch.ones_like(point)
        cs = torch.zeros(point.shape[1], dtype=torch.int64, device=dev)
        for i in range(self.g):
            active = i < length
            center = (lo + hi) * 0.5
            quad = torch.zeros(point.shape[1], dtype=torch.int64, device=dev)
            for d in range(self.dims):
                quad |= (point[d] >= center[d]).to(torch.int64) << d
            cs = torch.where(active, cs + steps[i][quad], cs)
            upper = ((quad[None, :] >> torch.arange(self.dims, device=dev)[:, None]) & 1) == 1
            lo = torch.where(active[None, :] & upper, center, lo)
            hi = torch.where(active[None, :] & ~upper, center, hi)
        return _hi_lo_t(cs)

    # -- query decomposition ----------------------------------------------

    def ranges(
        self,
        q_mins: np.ndarray,
        q_maxs: np.ndarray,
        max_ranges: int = DEFAULT_MAX_RANGES,
    ) -> "list[IndexRange]":
        """Query windows -> sorted merged inclusive ranges of sequence codes.

        q_mins/q_maxs MUST be shaped (dims, n_windows). A cell matches if its
        *enlarged* extent (2x per dim) intersects any window; if a window
        contains the enlarged extent the whole subtree is emitted as a
        contained range.
        """
        q_mins = np.asarray(q_mins, dtype=np.float64)
        q_maxs = np.asarray(q_maxs, dtype=np.float64)
        if q_mins.ndim != 2 or q_mins.shape[0] != self.dims:
            raise ValueError(
                f"expected (dims={self.dims}, n_windows) query arrays, "
                f"got shape {q_mins.shape}"
            )
        results: "list[IndexRange]" = []
        # node: (code_of_cell, level, lo tuple) -- cell corner + width 0.5^level
        queue: "deque[tuple[int, int, tuple[float, ...]]]" = deque()
        # the root "cell" is the unit cube, code 0, enlarged extent the whole
        # space: intersecting, not contained (code 0 is a valid stored value)
        queue.append((0, 0, (0.0,) * self.dims))
        while queue:
            code, level, lo = queue.popleft()
            width = 0.5**level
            contained = False
            intersects = False
            for wi in range(q_mins.shape[1]):
                cont = True
                isect = True
                for d in range(self.dims):
                    e_hi = lo[d] + 2 * width  # enlarged extent
                    if q_mins[d, wi] > e_hi or q_maxs[d, wi] < lo[d]:
                        isect = False
                        cont = False
                        break
                    if not (q_mins[d, wi] <= lo[d] and q_maxs[d, wi] >= e_hi):
                        cont = False
                if cont:
                    contained = True
                    break
                intersects = intersects or isect
            if contained:
                results.append(IndexRange(code, code + self.subtree_size(level), True))
                continue
            if not intersects:
                continue
            # partial overlap: this cell's own code matches; refine children
            # unless at max depth or out of budget
            if level == self.g or len(results) + len(queue) >= max_ranges:
                # emit the whole subtree as an over-covering range
                results.append(IndexRange(code, code + self.subtree_size(level), False))
                continue
            results.append(IndexRange(code, code, False))
            half = width * 0.5
            for quad in range(self.fanout):
                child_lo = tuple(
                    lo[d] + (half if (quad >> d) & 1 else 0.0) for d in range(self.dims)
                )
                child_code = code + 1 + quad * self._child_step(level)
                queue.append((child_code, level + 1, child_lo))
        results.sort(key=lambda r: r.lower)
        merged: "list[IndexRange]" = []
        for r in results:
            if merged and r.lower <= merged[-1].upper + 1:
                last = merged[-1]
                merged[-1] = IndexRange(
                    last.lower, max(last.upper, r.upper), last.contained and r.contained
                )
            else:
                merged.append(r)
        return merged
