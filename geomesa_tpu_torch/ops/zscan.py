"""Resident key-plane scans: the de-interleaved dim planes and the
interleaved masked-compare planes, with their query builders, kernel
wrappers and plain PyTorch versions.

Counterpart of ``geomesa_tpu/ops/zscan.py``: the point kinds' scans (z3,
z2) and the range masks of the extent-curve kinds (xz3, xz2).

*Dim planes.* Morton order exists for sorting; a resident scan keeps the
SAME key de-interleaved -- nx, ny uint32 planes plus ONE packed bt word
((bin - bin_base) << 21 | nt) -- and answers the cell-granular loose
query with a few compares per row. Contiguous query bins merge into one
bt range, so a multi-week window costs 2 compares, not 2 per bin. The
kernels of ``csrc/dimscan.cu`` replace ``build_z3_dimscan_rt`` and
``build_z2_dimscan_rt``; ``csrc/dimscan_baked.cu`` replaces
``build_z3_dimscan_pallas``, the cross-check engine with the query held
as kernel constants.

*Interleaved planes* (``__zbin`` int32, ``__zhi``/``__zlo`` uint32: the
Morton key as two words). Bit spreading is monotonic per dimension, so
``extract_d(z) in [lo_d, hi_d]`` is exactly ``spread_d(lo_d) <= (z &
dim_mask_d) <= spread_d(hi_d)``: one AND and two 64-bit compares per
dimension. A time-binned Z3 key (bin, z) gets bounds per period bin, and
a row matches when its bin's entry matches. This layout serves
``dim_planes=False`` and z3 data whose bin span does not pack into the bt
word. The kernels of ``csrc/zscan.cu`` replace ``build_z3_pallas_scan``
and also serve the unbinned z2 mask.

Each wrapper launches its kernel for CUDA tensors and uses the plain
version only for tensors that lie on the CPU. Torch has no ordered
compares on uint32, so the plain versions widen unsigned words to int64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.bucketing import bucket_cap
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.binnedtime import bins_for_interval, max_offset
from geomesa_tpu_torch.ops.int64lanes import widen_u32

BT_TIME_BITS = 21  # nt occupies the low 21 bits of bt
BT_BIN_SPAN = 1 << (32 - BT_TIME_BITS)  # max bins representable (2^11)
MAX_RANGES = 8  # z3_dim_plane_qarr's max_ranges: R buckets {1, 2, 4, 8}
_U32 = 0xFFFFFFFF


def z3_dim_planes(sfc, nx, ny, nt, bins, bin_base: int):
    """Pack quantized dims + bins into the uint32 scan planes.

    ``nx``/``ny``/``nt`` are integer tensors of quantized dims, ``bins``
    the period bins (any integer dtype). Rows whose ``bins - bin_base``
    falls outside [0, BT_BIN_SPAN - 1) get the SENTINEL bt 0xFFFFFFFF --
    the top packable bin's space, which the query builder never addresses
    -- so out-of-window rows are unmatchable rather than wrapping into
    another bin's key space. The counterpart relies on uint32 wrap of
    ``bins - bin_base``; here the wrap is explicit in int64."""
    if sfc.precision != BT_TIME_BITS:
        raise ValueError(
            f"dim-plane packing requires precision {BT_TIME_BITS} "
            f"(got {sfc.precision})"
        )
    rel = (bins.to(torch.int64) - int(bin_base)) & _U32
    bt = ((rel << BT_TIME_BITS) | (nt.to(torch.int64) & _U32)) & _U32
    bt = torch.where(rel >= BT_BIN_SPAN - 1, torch.full_like(bt, _U32), bt)
    return _u32(nx), _u32(ny), _u32(bt)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding values in [0, 2^32) -> uint32, bits kept."""
    if t.dtype == torch.uint32:
        return t
    return t.to(torch.int64).to(torch.int32).view(torch.uint32)


def _dim_plane_query(sfc, env, window, bin_base: int, bin_range):
    """(qnx, qny, bt_ranges) for the z3 dim planes, or None when a query
    bin that survives ``bin_range`` falls outside the packable window."""
    if sfc.precision != BT_TIME_BITS:
        return None  # planes for this sfc cannot have been packed
    xmin, ymin, xmax, ymax = env
    qnx = (int(sfc.lon.normalize(xmin)), int(sfc.lon.normalize(xmax)))
    qny = (int(sfc.lat.normalize(ymin)), int(sfc.lat.normalize(ymax)))
    ranges: list = []
    for b, lo_off, hi_off in bins_for_interval(
        int(window[0]), int(window[1]), sfc.period
    ):
        if bin_range is not None and not (bin_range[0] <= b <= bin_range[1]):
            continue  # bin not staged: matches nothing
        rel = b - bin_base
        # top bin reserved: the sentinel space of z3_dim_planes
        if not (0 <= rel < BT_BIN_SPAN - 1):
            return None
        lo = (rel << BT_TIME_BITS) | int(sfc.time.normalize(lo_off))
        hi = (rel << BT_TIME_BITS) | int(sfc.time.normalize(hi_off))
        if ranges and lo == ranges[-1][1] + 1:
            ranges[-1] = (ranges[-1][0], hi)
        else:
            ranges.append((lo, hi))
    return qnx, qny, ranges


def z3_dim_plane_query(
    sfc,
    xmin: float,
    ymin: float,
    xmax: float,
    ymax: float,
    tmin_ms: int,
    tmax_ms: int,
    bin_base: int,
) -> "tuple[tuple, tuple, list] | None":
    """(qnx, qny, bt_ranges) for the dim-plane scan, or None when a query
    bin falls outside the packable window. Contiguous bins merge into
    single inclusive bt ranges."""
    return _dim_plane_query(
        sfc, (xmin, ymin, xmax, ymax), (tmin_ms, tmax_ms), bin_base, None
    )


def z3_dim_plane_qarr(
    sfc,
    env,
    window,
    bin_base: int,
    bin_range: "tuple | None",
    max_ranges: int = MAX_RANGES,
) -> "tuple[np.ndarray, int] | None":
    """Runtime query vector for the z3 dim scan: uint32
    ``[qnx_lo, qnx_hi, qny_lo, qny_hi, (bt_lo, bt_hi) * R]`` with R padded
    to a power of two by inverted (never-matching) ranges.

    ``bin_range`` clamps to the bins actually staged. Returns None when a
    surviving query bin falls outside the packable window relative to
    ``bin_base`` or the merged range count exceeds ``max_ranges`` (the
    caller then answers through the exact path)."""
    q = _dim_plane_query(sfc, env, window, bin_base, bin_range)
    if q is None:
        return None
    qnx, qny, ranges = q
    if len(ranges) > max_ranges:
        return None
    r = bucket_cap(len(ranges))
    out = np.empty(4 + 2 * r, np.uint32)
    if ranges:
        out[0:4] = [qnx[0], qnx[1], qny[0], qny[1]]
    else:
        out[0:4] = [1, 0, 1, 0]  # inverted: matches nothing
    for k in range(r):
        lo, hi = ranges[k] if k < len(ranges) else (_U32, 0)
        out[4 + 2 * k] = lo
        out[5 + 2 * k] = hi
    return out, r


def z2_dim_plane_qarr(sfc, env) -> np.ndarray:
    """Runtime query vector for the unbinned 2-plane dim scan: uint32
    ``[qnx_lo, qnx_hi, qny_lo, qny_hi]``."""
    xmin, ymin, xmax, ymax = env
    return np.array(
        [
            int(sfc.lon.normalize(xmin)), int(sfc.lon.normalize(xmax)),
            int(sfc.lat.normalize(ymin)), int(sfc.lat.normalize(ymax)),
        ],
        np.uint32,
    )


# -- dim-scan kernel wrappers ------------------------------------------------


def dimscan_plain(qarr: np.ndarray, nx, ny, bt=None, valid=None) -> torch.Tensor:
    """Plain PyTorch version of the dim scan: the bool hit mask, ANDed with
    ``valid`` when given. Unsigned words are widened to int64 (torch has no
    ordered uint32 compares)."""
    q = [int(v) for v in np.asarray(qarr, np.uint32)]
    a, b = widen_u32(nx), widen_u32(ny)
    m = (a >= q[0]) & (a <= q[1]) & (b >= q[2]) & (b <= q[3])
    if bt is not None:
        t = widen_u32(bt)
        tm = torch.zeros_like(m)
        for k in range((len(q) - 4) // 2):
            tm |= (t >= q[4 + 2 * k]) & (t <= q[5 + 2 * k])
        m &= tm
    return kernels.and_valid(m, valid)


def _check_dim_args(qarr, planes) -> int:
    q = np.asarray(qarr)
    if q.dtype != np.uint32 or q.ndim != 1:
        raise TypeError("qarr must be a 1-D uint32 array")
    r = (len(q) - 4) // 2
    three = len(planes) == 3
    if len(q) != 4 + 2 * r or (r not in (1, 2, 4, 8) if three else r != 0):
        raise ValueError(
            f"qarr of length {len(q)} does not fit a "
            f"{len(planes)}-plane dim scan"
        )
    _check_dim_planes(planes)
    return r


def _check_dim_planes(planes) -> None:
    n = planes[0].shape
    dev = planes[0].device
    for p in planes:
        if p.dtype != torch.uint32 or p.dim() != 1 or p.shape != n:
            raise TypeError("dim-scan planes must be 1-D uint32 of one length")
        if p.device != dev or not p.is_contiguous():
            raise ValueError("dim-scan planes must be contiguous on one device")


_MAX_ROWS = 2**31 - 1 - 1024  # counts are int32


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev`` without a stream synchronisation: a pinned
    copy, then a non-blocking copy on the current stream. PyTorch's pinned
    allocator keeps the pinned block from reuse until that copy has run,
    so the caller may drop it at once."""
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


def _launch_dimscan(qarr, planes, want_mask: bool, valid=None) -> torch.Tensor:
    from geomesa_tpu_torch.kernels import _build

    r = _check_dim_args(qarr, planes)
    nx = planes[0]
    n = nx.shape[0]
    kernels.check_valid(valid, n, nx.device)
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 count range")
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError("dim-scan planes must be 16-byte aligned")
    fn = _build.load("dimscan").gm_dimscan
    q = np.ascontiguousarray(qarr, np.uint32)
    bt = planes[2] if len(planes) == 3 else None
    with torch.cuda.device(nx.device):
        out = (
            torch.empty(n, dtype=torch.bool, device=nx.device)
            if want_mask
            else torch.empty((), dtype=torch.int32, device=nx.device)
        )
        rc = fn(
            nx.data_ptr(), planes[1].data_ptr(),
            bt.data_ptr() if bt is not None else None, kernels.valid_ptr(valid),
            n, q.ctypes.data, r, int(want_mask), out.data_ptr(),
            torch.cuda.current_stream(nx.device).cuda_stream,
        )
    name = f"dimscan_{'z3' if bt is not None else 'z2'}_{'mask' if want_mask else 'count'}"
    kernels.check_status(rc, name)
    kernels.count_launch(name, valid=valid is not None)
    return out


def dimscan_count(qarr: np.ndarray, nx, ny, bt=None, valid=None) -> torch.Tensor:
    """int32 hit count of the dim scan (z3 with ``bt``, z2 without) over
    the rows ``valid`` marks live (None: every row): the CUDA kernel for
    CUDA planes, the plain version for CPU planes."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan(qarr, planes, want_mask=False, valid=valid)
    _check_dim_args(qarr, planes)
    kernels.check_valid(valid, nx.shape[0], nx.device)
    return dimscan_plain(qarr, nx, ny, bt, valid).sum(dtype=torch.int32)


def dimscan_mask(qarr: np.ndarray, nx, ny, bt=None, valid=None) -> torch.Tensor:
    """bool hit mask of the dim scan, False on dead rows; routing as
    :func:`dimscan_count`."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan(qarr, planes, want_mask=True, valid=valid)
    _check_dim_args(qarr, planes)
    kernels.check_valid(valid, nx.shape[0], nx.device)
    return dimscan_plain(qarr, nx, ny, bt, valid)


# -- the Q-batched dim scan (the scheduler's fused loose paths) --------------

MAX_BATCH = 64  # queries one batched launch answers


def batched_dim_mask_rt(n_ranges: int):
    """Plain PyTorch version of the Q-batched dim scan: a function of
    ``(nx, ny, bt, qmat, valid=None)`` (``(nx, ny, qmat, ...)`` when
    ``n_ranges`` is 0, the z2 scan) that stacks :func:`dimscan_plain` of
    each row of ``qmat``, the (Q, 4 + 2R) uint32 stack of query vectors,
    into a (Q, n) bool mask, every row ANDed with ``valid``. The
    counterpart vmaps its XLA single-query mask the same way."""
    def run(*args, valid=None):
        *planes, qmat = args
        if len(planes) != (2 if n_ranges == 0 else 3):
            raise ValueError(f"R = {n_ranges} takes {2 if n_ranges == 0 else 3} planes")
        return torch.stack([dimscan_plain(row, *planes, valid=valid)
                            for row in np.asarray(qmat, np.uint32)])

    return run


def _check_qmat(qmat, planes) -> int:
    q = np.asarray(qmat)
    if q.dtype != np.uint32 or q.ndim != 2:
        raise TypeError("qmat must be a 2-D uint32 array")
    if not 1 <= q.shape[0] <= MAX_BATCH:
        raise ValueError(f"{q.shape[0]} queries: a batched launch takes 1 to {MAX_BATCH}")
    return _check_dim_args(q[0], planes)


# A count of a group of at most this many compares a row, Q x (4 + 2R), and a
# mask of at most the second, take the compare way (gm_dimscan_batched_compare),
# others the lookup way: in tools/dimscan_batched_probe.py's A/B of the two
# ways at 2^26 rows, the compare way's counts were the faster up to about 32
# compares and the lookup way's past them; the lookup way's masks, which
# store 8 rows of a query at once, were as fast or faster past 12 compares
# (z2's at every width, but one threshold serves both kinds).
DIMSCAN_COUNT_COMPARE_MAX, DIMSCAN_MASK_COMPARE_MAX = 32, 12


@functools.lru_cache(maxsize=None)
def _eytzinger(depth: int) -> np.ndarray:
    """For the complete search tree of 2^depth - 1 sorted values laid out
    breadth-first (node i's children 2i and 2i + 1, the root at 1): entry i
    is the sorted position of node i's value. Entry 0, which the search
    never reads, is 0."""
    order = np.zeros(1 << depth, np.int64)
    for level in range(depth):
        p = np.arange(1 << level)
        order[(1 << level) + p] = (2 * p + 1) * (1 << (depth - 1 - level)) - 1
    return order


@functools.lru_cache(maxsize=None)
def _group_ranges(nq: int, r: int) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
    """A (Q, 4 + 2R) group's ranges, flat by dimension (nx of every query,
    ny, then bt, R a query): their lo and hi positions in the flat qmat,
    their dimension and their query."""
    w, q = 4 + 2 * r, np.arange(nq)
    bt = (w * q[:, None] + 4 + 2 * np.arange(r)).reshape(-1)
    lo = np.concatenate([w * q, w * q + 2, bt])
    dim = np.repeat(np.arange(3), [nq, nq, nq * r])
    return lo, lo + 1, dim, np.concatenate([q, q, np.repeat(q, r)])


def _dim_intervals(q: np.ndarray, r: int, n_dims: int) -> "tuple[list, np.ndarray, np.ndarray]":
    """(cuts per dimension, first, words) of a (Q, 4 + 2R) uint32 group. A
    dimension's cuts are lo and hi + 1 of its ranges with lo <= hi, sorted
    and distinct, without 0 and without 2^32 (hi = 0xFFFFFFFF); its m cuts
    split [0, 2^32) into m + 1 intervals, interval i starting at 0 (i = 0)
    or at cuts[i - 1]. Inverted ranges (the fused paths' padding) add
    nothing. All dimensions go through each numpy call at once, as keys dim
    << 33 | value: dimension d's cuts are keys [first[d], first[d + 1]), its
    interval i is words[first[d] + d + i], whose bit q is set when a range
    of query q (a query's bt ranges ORed) holds the interval."""
    nq = q.shape[0]
    at_lo, at_hi, dim, qid = _group_ranges(nq, r)
    flat = q.reshape(-1).astype(np.int64)
    lo, end = flat[at_lo], flat[at_hi] + 1
    real = lo < end
    top = dim << 33
    klo, kend = top | lo, top | end
    keys = np.unique(np.concatenate([klo[real], kend[real]]))
    value = keys & ((1 << 33) - 1)
    keys = keys[(value > 0) & (value <= _U32)]
    first = np.searchsorted(keys >> 33, np.arange(n_dims + 1))
    total = int(first[-1]) + n_dims + 1  # every interval, and one past the last
    at = qid * total + dim
    start = at + np.searchsorted(keys, klo, side="right")
    stop = at + np.searchsorted(keys, kend, side="right") + (end > _U32)
    cover = np.bincount(start[real], minlength=nq * total) - \
        np.bincount(stop[real], minlength=nq * total)
    inside = np.zeros((MAX_BATCH, total), bool)
    inside[:nq] = np.cumsum(cover.reshape(nq, total), axis=1) > 0
    words = np.packbits(inside, axis=0, bitorder="little").T.copy().view(np.uint64)[:, 0]
    return [keys[first[d]: first[d + 1]] & _U32 for d in range(n_dims)], first, words


class _BatchedDimScan:
    """A group of Q dim-scan query vectors (the (Q, 4 + 2R) ``qmat`` of
    :func:`batched_dimscan_count`), packed once for the batched kernel,
    which answers it one of two ways, chosen at each launch by the group's
    shape and the output (``compare`` None) or forced (True, False):

    - the compare way (``gm_dimscan_batched_compare``) when the group's
      compares a row, Q x (4 + 2R), are at most ``DIMSCAN_COUNT_COMPARE_MAX``
      for a count or ``DIMSCAN_MASK_COMPARE_MAX`` for a mask: every row
      tests every query vector, and the table is ``qmat`` itself;
    - else the lookup way (``gm_dimscan_batched``). Per dimension (nx, ny
      and, when R > 0, bt) the group's ranges cut the uint32 line into
      intervals (:func:`_dim_intervals`), each with a 64-bit word of the
      queries whose ranges hold it; a row's hit word is the AND of its
      intervals' words. The m cuts pad with 0xFFFFFFFF to 2^d - 1 (d = the
      bit length of m: at most 8 for nx and ny, whose 64 queries give at
      most 128 cuts, and 11 for bt's 1,024) in breadth-first
      order (:func:`_eytzinger`, entry 0 unused), and the words to 2^d by
      repeating the last interval's: after d steps down the tree a row's
      rank is the number of cuts <= its value, padding included for a row
      at 0xFFFFFFFF, and the word at that rank is its interval's. The
      uint32 table is the 2^d words (two uint32 each, low first) of every
      dimension, then the 2^d cut words of every dimension, padded to a
      multiple of 4.

    The lookup layout (``cuts``, ``depths``, ``lookup_table``) is packed at
    the first launch that takes that way, or when :meth:`plain` or
    ``depths`` asks for it."""

    def __init__(self, qmat, compare: "bool | None" = None):
        q = np.asarray(qmat)
        if q.dtype != np.uint32 or q.ndim != 2:
            raise TypeError("qmat must be a 2-D uint32 array")
        if not 1 <= q.shape[0] <= MAX_BATCH:
            raise ValueError(f"{q.shape[0]} queries: a batched launch takes 1 to {MAX_BATCH}")
        r = (q.shape[1] - 4) // 2
        if q.shape[1] != 4 + 2 * r or r not in (0, 1, 2, 4, 8):
            raise ValueError(f"qmat rows of {q.shape[1]} words are no dim-scan query vectors")
        self.qmat = np.ascontiguousarray(q)
        self.nq, self.n_ranges = q.shape[0], r
        self.n_dims = 3 if r else 2
        self.forced = compare
        self._lookup = None
        self._dev: dict = {}

    def takes_compare(self, want_mask: bool) -> bool:
        """Whether a count (a mask, ``want_mask``) takes the compare way."""
        if self.forced is not None:
            return bool(self.forced)
        top = DIMSCAN_MASK_COMPARE_MAX if want_mask else DIMSCAN_COUNT_COMPARE_MAX
        return self.nq * (4 + 2 * self.n_ranges) <= top

    def table(self, compare: bool) -> np.ndarray:
        """The uint32 table a way reads: ``qmat``'s rows, or the lookup table."""
        return self.qmat.reshape(-1) if compare else self.lookup_table

    def _pack(self):
        """(cuts, depths, table) of the lookup way, packed once."""
        if self._lookup is not None:
            return self._lookup
        cuts, first, words = _dim_intervals(self.qmat, self.n_ranges, self.n_dims)
        depths = [len(c).bit_length() for c in cuts]
        parts = []
        for d, (depth, c) in enumerate(zip(depths, cuts)):
            # the words by rank: those past the last interval repeat it
            rank = np.minimum(np.arange(1 << depth), len(c))
            parts.append(words[first[d] + d + rank].view(np.uint32))
        for depth, c in zip(depths, cuts):
            node = _eytzinger(depth)[1:]
            tree = np.zeros(1 << depth, np.uint32)
            tree[1:] = np.where(node < len(c), c[np.minimum(node, len(c) - 1)], _U32)
            parts.append(tree)
        table = np.concatenate(parts)
        table = np.concatenate([table, np.zeros(-len(table) % 4, np.uint32)])
        self._lookup = (cuts, depths, table)
        return self._lookup

    @property
    def cuts(self) -> list:
        return self._pack()[0]

    @property
    def depths(self) -> list:
        return self._pack()[1]

    @property
    def lookup_table(self) -> np.ndarray:
        return self._pack()[2]

    def _layout(self):
        """Per dimension (sorted padded cuts, words) as int64, read back from
        the lookup way's table: the plain version's view of what the kernel
        reads."""
        _, depths, table = self._pack()
        leaves = [1 << d for d in depths]
        at = 2 * sum(leaves)
        words = np.split(table[:at].view(np.int64), np.cumsum(leaves)[:-1])
        out = []
        for d, w in zip(depths, words):
            tree = table[at: at + (1 << d)].astype(np.int64)
            at += 1 << d
            padded = np.empty((1 << d) - 1, np.int64)
            padded[_eytzinger(d)[1:]] = tree[1:]
            out.append((padded, w))
        return out

    def plain(self, *planes, valid=None) -> torch.Tensor:
        """Plain PyTorch version on the lookup way's layout: per dimension
        the rank of each row among the padded cuts (``torch.searchsorted``),
        the word at that rank, the AND over the dimensions; then the (Q, n)
        bool masks, every row ANDed with ``valid``. The compare way's plain
        version is :func:`batched_dim_mask_rt` on ``qmat``."""
        dev = planes[0].device
        hit = None
        for (padded, words), plane in zip(self._layout(), planes):
            rank = torch.searchsorted(torch.from_numpy(padded).to(dev), widen_u32(plane), right=True)
            w = torch.from_numpy(words).to(dev)[rank]
            hit = w if hit is None else hit & w
        out = torch.empty((self.nq, planes[0].shape[0]), dtype=torch.bool, device=dev)
        for q in range(self.nq):
            out[q] = ((hit >> q) & 1).bool()
        return kernels.and_valid(out, valid)

    def device_table(self, dev, want_mask: bool = False) -> torch.Tensor:
        """The table of the way a count (a mask) takes, on ``dev``, uploaded
        once (see :func:`_upload`)."""
        key = (dev, self.takes_compare(want_mask))
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = _upload(self.table(key[1]), dev)
        return t

    def run(self, planes, want_mask: bool, valid=None) -> torch.Tensor:
        """The (Q,) int32 counts or (Q, n) bool masks over ``planes`` (nx, ny
        and, when R > 0, bt): the kernel for CUDA planes, :meth:`plain` for
        CPU planes."""
        if len(planes) != self.n_dims:
            raise ValueError(f"R = {self.n_ranges} takes {self.n_dims} planes")
        _check_dim_planes(planes)
        kernels.check_valid(valid, planes[0].shape[0], planes[0].device)
        if not kernels.on_cuda(planes[0]):
            m = self.plain(*planes, valid=valid)
            return m if want_mask else m.sum(dim=1, dtype=torch.int32)
        return self._launch(planes, want_mask, valid)

    def _launch(self, planes, want_mask: bool, valid=None) -> torch.Tensor:
        from geomesa_tpu_torch.kernels import _build

        nx = planes[0]
        n = nx.shape[0]
        if n > _MAX_ROWS:
            raise ValueError(f"{n} rows exceed the int32 count range")
        if any(p.data_ptr() % 16 for p in planes):
            raise ValueError("dim-scan planes must be 16-byte aligned")
        lib = _build.load("dimscan")
        bt = planes[2] if len(planes) == 3 else None
        dev = nx.device
        with torch.cuda.device(dev):
            tab = self.device_table(dev, want_mask)
            out = (
                torch.empty((self.nq, n), dtype=torch.bool, device=dev)
                if want_mask
                else torch.empty(self.nq, dtype=torch.int32, device=dev)
            )
            head = (nx.data_ptr(), planes[1].data_ptr(), bt.data_ptr() if bt is not None else None,
                    kernels.valid_ptr(valid), n, tab.data_ptr())
            tail = (int(want_mask), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if self.takes_compare(want_mask):
                rc = lib.gm_dimscan_batched_compare(*head, self.nq, self.n_ranges, *tail)
            else:
                dx, dy, dt = (self.depths + [0])[:3]
                rc = lib.gm_dimscan_batched(*head, len(self.lookup_table), self.nq, self.n_dims,
                                            dx, dy, dt, *tail)
        name = f"dimscan_batched_{'z3' if bt is not None else 'z2'}_{'mask' if want_mask else 'count'}"
        kernels.check_status(rc, name)
        kernels.count_launch(name, q=self.nq, valid=valid is not None)
        return out


def batched_dimscan(qmat, compare: "bool | None" = None) -> _BatchedDimScan:
    """Pack a group of dim-scan query vectors, the (Q, 4 + 2R) uint32
    ``qmat`` of :func:`batched_dimscan_count`, for the batched kernel: each
    launch's way chosen by the group's shape and output, or forced by
    ``compare``."""
    return _BatchedDimScan(qmat, compare)


def _launch_dimscan_batched(qmat, planes, want_mask: bool, valid=None) -> torch.Tensor:
    _check_qmat(qmat, planes)
    kernels.check_valid(valid, planes[0].shape[0], planes[0].device)
    return _BatchedDimScan(qmat)._launch(planes, want_mask, valid)


def batched_dimscan_count(qmat: np.ndarray, nx, ny, bt=None, valid=None) -> torch.Tensor:
    """(Q,) int32 hit counts of the Q queries of ``qmat`` (each row a query
    vector of :func:`dimscan_count`, 1 <= Q <= 64) over the rows ``valid``
    marks live (None: every row), in one pass over the planes: the kernel
    ``gm_dimscan_batched`` on the group packed by :class:`_BatchedDimScan`
    for CUDA planes, the plain version :func:`batched_dim_mask_rt` for CPU
    planes."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan_batched(qmat, planes, want_mask=False, valid=valid)
    r = _check_qmat(qmat, planes)
    kernels.check_valid(valid, nx.shape[0], nx.device)
    return batched_dim_mask_rt(r)(*planes, qmat, valid=valid).sum(dim=1, dtype=torch.int32)


def batched_dimscan_mask(qmat: np.ndarray, nx, ny, bt=None, valid=None) -> torch.Tensor:
    """(Q, n) bool hit masks, row q for query q, False on dead rows;
    routing as :func:`batched_dimscan_count`."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan_batched(qmat, planes, want_mask=True, valid=valid)
    r = _check_qmat(qmat, planes)
    kernels.check_valid(valid, nx.shape[0], nx.device)
    return batched_dim_mask_rt(r)(*planes, qmat, valid=valid)


# -- baked-constant dim scan (the cross-check engine) ------------------------

BAKED_MAX_RANGES = 2047  # every window a packed bt plane can address


def z3_dimscan_mask(nx, ny, bt, qnx, qny, bt_ranges) -> torch.Tensor:
    """Plain PyTorch version of the baked dim scan: nx in qnx, ny in qny
    and bt in any of ``bt_ranges`` (inclusive, compared as uint32); no
    range matches nothing."""
    a, b, t = widen_u32(nx), widen_u32(ny), widen_u32(bt)
    m = (a >= int(qnx[0])) & (a <= int(qnx[1])) & (b >= int(qny[0])) & (b <= int(qny[1]))
    tm = torch.zeros_like(m)
    for lo, hi in bt_ranges:
        tm |= (t >= int(lo)) & (t <= int(hi))
    return m & tm


def _launch_dimscan_baked(q: np.ndarray, ranges: np.ndarray, planes, want_mask: bool):
    from geomesa_tpu_torch.kernels import _build

    nx = planes[0]
    n = nx.shape[0]
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 count range")
    fn = _build.load("dimscan_baked").gm_dimscan_baked
    with torch.cuda.device(nx.device):
        out = (
            torch.empty(n, dtype=torch.bool, device=nx.device)
            if want_mask
            else torch.empty((), dtype=torch.int32, device=nx.device)
        )
        rc = fn(
            nx.data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), n,
            q.ctypes.data, ranges.ctypes.data, len(ranges), int(want_mask),
            out.data_ptr(), torch.cuda.current_stream(nx.device).cuda_stream,
        )
    name = f"dimscan_baked_{'mask' if want_mask else 'count'}"
    kernels.check_status(rc, name)
    kernels.count_launch(name)
    return out


def build_z3_dimscan_pallas(qnx, qny, bt_ranges):
    """(count_fn, mask_fn) over (nx, ny, bt) uint32 dim planes with the
    query -- (qnx, qny) and any number of inclusive bt ranges, as
    :func:`z3_dim_plane_query` gives them -- held as kernel constants
    (``csrc/dimscan_baked.cu``): the counterpart's cross-check engine.
    Serving uses the runtime-bounds kernel (:func:`dimscan_count`); this
    one is a separate, plain design to hold it against. CUDA planes launch
    the kernel, CPU planes take :func:`z3_dimscan_mask`."""
    q = np.array([qnx[0], qnx[1], qny[0], qny[1]], np.uint32)
    ranges = np.array([[lo, hi] for lo, hi in bt_ranges], np.uint32).reshape(-1, 2)
    if len(ranges) > BAKED_MAX_RANGES:
        raise ValueError(f"{len(ranges)} bt ranges exceed {BAKED_MAX_RANGES}")

    def run(nx, ny, bt, want_mask: bool):
        _check_dim_planes((nx, ny, bt))
        if kernels.on_cuda(nx):
            return _launch_dimscan_baked(q, ranges, (nx, ny, bt), want_mask)
        m = z3_dimscan_mask(nx, ny, bt, q[:2], q[2:], ranges)
        return m if want_mask else m.sum(dtype=torch.int32)

    return (
        lambda nx, ny, bt: run(nx, ny, bt, want_mask=False),
        lambda nx, ny, bt: run(nx, ny, bt, want_mask=True),
    )


# -- interleaved masked-compare layout ---------------------------------------

# a kernel launch stages the bound entries and the bin-to-entry table in
# shared memory: at most 512 entries (36 KB) and a bin span of 2,048 (8 KB)
ZSCAN_MAX_ENTRIES = 512
ZSCAN_MAX_SPAN = 2048


def _hi_lo(v) -> "tuple[int, int]":
    hi, lo = zorder.u64_hi_lo(v)
    return int(hi), int(lo)


def _dim_bounds(qlo: tuple, qhi: tuple, split, max_mask: int, n_dims: int):
    """Per-dimension masked-compare bounds for one z cell box: per dim d
    the columns are (mask_hi, mask_lo, lo_hi, lo_lo, hi_hi, hi_lo), where
    mask keeps only dim d's interleaved bit positions and lo/hi are the
    spread (inclusive) cell bounds."""
    u = np.uint64
    out = np.empty((n_dims, 6), np.uint32)
    for d in range(n_dims):
        mask = split(u(max_mask)) << u(d)
        blo = split(u(qlo[d])) << u(d)
        bhi = split(u(qhi[d])) << u(d)
        out[d, 0:2] = _hi_lo(mask)
        out[d, 2:4] = _hi_lo(blo)
        out[d, 4:6] = _hi_lo(bhi)
    return out


def z3_dim_bounds(qlo: tuple, qhi: tuple) -> np.ndarray:
    """(3, 6) uint32 bounds for one Z3 cell box (21-bit x/y/t corners)."""
    return _dim_bounds(qlo, qhi, zorder.split_3d_np, zorder.MAX_MASK_3D, 3)


def z2_dim_bounds(qlo: tuple, qhi: tuple) -> np.ndarray:
    """(2, 6) uint32 bounds for one Z2 cell box (31-bit x/y corners)."""
    return _dim_bounds(qlo, qhi, zorder.split_2d_np, zorder.MAX_MASK_2D, 2)


def z3_query_bounds(
    sfc,
    xmin: float,
    ymin: float,
    xmax: float,
    ymax: float,
    tmin_ms: int,
    tmax_ms: int,
) -> "tuple[np.ndarray, np.ndarray]":
    """(bounds (B, 3, 6), bin_ids (B,)) for a bbox + absolute-ms window:
    one entry per period bin the window touches; edge bins get partial
    offset ranges, interior bins the full offset span (loose semantics:
    cell-granular, no residual refinement)."""
    qx = (int(sfc.lon.normalize(xmin)), int(sfc.lon.normalize(xmax)))
    qy = (int(sfc.lat.normalize(ymin)), int(sfc.lat.normalize(ymax)))
    bounds, ids = [], []
    for b, lo_off, hi_off in bins_for_interval(int(tmin_ms), int(tmax_ms), sfc.period):
        qt = (int(sfc.time.normalize(lo_off)), int(sfc.time.normalize(hi_off)))
        bounds.append(z3_dim_bounds((qx[0], qy[0], qt[0]), (qx[1], qy[1], qt[1])))
        ids.append(b)
    if not bounds:  # empty/inverted window: zero bins, matches nothing
        return np.zeros((0, 3, 6), np.uint32), np.array([], np.int32)
    return np.stack(bounds), np.array(ids, np.int32)


def pad_bins(bounds: np.ndarray, bin_ids: np.ndarray, min_b: int = 1):
    """Pad the bin axis to the next power of two (at least ``min_b``);
    pad ids are -1 and never match."""
    b = len(bin_ids)
    cap = bucket_cap(b, floor=min_b)
    if cap == b:
        return bounds, bin_ids
    pb = np.zeros((cap,) + bounds.shape[1:], bounds.dtype)
    pb[:b] = bounds
    pi = np.full(cap, -1, np.int32)
    pi[:b] = bin_ids
    return pb, pi


def _ge64(a_hi, a_lo, b_hi: int, b_lo: int):
    return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo >= b_lo))


def _le64(a_hi, a_lo, b_hi: int, b_lo: int):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def _dims_mask(zh, zl, bounds: np.ndarray, n_dims: int) -> torch.Tensor:
    """AND of the per-dimension masked compares over widened key words;
    ``bounds`` is (n_dims, 6) uint32."""
    m = None
    for d in range(n_dims):
        mask_hi, mask_lo, lo_hi, lo_lo, hi_hi, hi_lo = (int(v) for v in bounds[d])
        zm_hi, zm_lo = zh & mask_hi, zl & mask_lo
        md = _ge64(zm_hi, zm_lo, lo_hi, lo_lo) & _le64(zm_hi, zm_lo, hi_hi, hi_lo)
        m = md if m is None else m & md
    return m


def z3_zscan_mask(z_hi, z_lo, bins, bounds, bin_ids) -> torch.Tensor:
    """Plain PyTorch version of the binned interleaved scan: the bool hit
    mask ``any_b(bins == bin_ids[b] and the 3 masked compares of
    bounds[b])``. Entries with ``bin_ids[b] < 0`` are padding and never
    match, as in the counterpart's Pallas kernel (its XLA mask compares
    padded ids like any other, so a row in bin -1 would match a padded
    entry's all-zero bounds there)."""
    bounds = np.asarray(bounds, np.uint32)
    ids = np.asarray(bin_ids, np.int32)
    zh, zl = widen_u32(z_hi), widen_u32(z_lo)
    bn = bins.to(torch.int32)
    total = torch.zeros(z_hi.shape, dtype=torch.bool, device=z_hi.device)
    for b in range(len(ids)):
        if ids[b] >= 0:
            total |= (bn == int(ids[b])) & _dims_mask(zh, zl, bounds[b], 3)
    return total


def entry_table(bin_ids) -> "tuple[int, np.ndarray]":
    """(first_bin, entry_of): the dense int32 table from bin to bound
    entry that the interleaved kernel reads, ``entry_of[bin - first_bin]``
    for every bin from the least to the greatest id >= 0, -1 where no entry
    has that bin. Padding (ids < 0) has no place in it; no ids >= 0 gives
    an empty table. Raises for two entries of one bin and for a span past
    ``ZSCAN_MAX_SPAN``."""
    ids = np.asarray(bin_ids, np.int32)
    real = np.nonzero(ids >= 0)[0]
    if not len(real):
        return 0, np.zeros(0, np.int32)
    first = int(ids[real].min())
    span = int(ids[real].max()) - first + 1
    if len(np.unique(ids[real])) != len(real):
        raise ValueError(f"bound entries share a bin: {ids.tolist()}")
    if span > ZSCAN_MAX_SPAN:
        raise ValueError(f"bound entries span {span} bins, past {ZSCAN_MAX_SPAN}")
    entry_of = np.full(span, -1, np.int32)
    entry_of[ids[real] - first] = real
    return first, entry_of


def z3_zscan_lookup(z_hi, z_lo, bins, bounds, first: int, entry_of) -> torch.Tensor:
    """Plain PyTorch version of the binned scan on the kernel's table
    layout: each row looks its entry up as ``entry_of[bin - first]`` (no
    entry outside the table or at -1) and runs that entry's 3 masked
    compares. Equal to :func:`z3_zscan_mask`, the semantic reference, for
    bound entries with distinct bin ids."""
    dev = z_hi.device
    b = torch.from_numpy(np.asarray(bounds, np.uint32).astype(np.int64)).to(dev)
    tab = torch.from_numpy(np.asarray(entry_of, np.int32)).to(dev)
    off = bins.to(torch.int64) - int(first)
    inside = (off >= 0) & (off < len(tab))
    e = torch.full(bins.shape, -1, dtype=torch.int64, device=dev)
    if len(tab):
        e = torch.where(inside, tab[off.clamp(0, len(tab) - 1)].to(torch.int64), e)
    hit = e >= 0
    if not len(b):
        return hit
    rows = b[e.clamp(min=0)]  # (n, 3, 6): the bounds of each row's entry
    zh, zl = widen_u32(z_hi), widen_u32(z_lo)
    for d in range(3):
        mask_hi, mask_lo, lo_hi, lo_lo, hi_hi, hi_lo = rows[:, d].unbind(1)
        zm_hi, zm_lo = zh & mask_hi, zl & mask_lo
        hit &= _ge64(zm_hi, zm_lo, lo_hi, lo_lo) & _le64(zm_hi, zm_lo, hi_hi, hi_lo)
    return hit


def z2_zscan_mask(z_hi, z_lo, bounds) -> torch.Tensor:
    """Plain PyTorch version of the unbinned Z2 interleaved scan;
    ``bounds`` is (2, 6) uint32."""
    return _dims_mask(widen_u32(z_hi), widen_u32(z_lo), np.asarray(bounds, np.uint32), 2)


# -- XZ (extent-curve) key scans ---------------------------------------------
#
# XZ codes are pre-order tree walks, not Morton interleaves, so there is no
# masked-compare trick: a query decomposes into a small list of inclusive
# [lo, hi] code ranges (budget-bounded, over-covering on truncation; see
# curves/xz.py ranges()), and a row matches when its code falls in one.
# The counterpart tests every row against every range, an (R, n)
# broadcast; here the ranges are merged and sorted once on the host and
# each row binary-searches them (torch.searchsorted), so a call reads the
# key planes once and holds no (R, n) intermediate. These are torch ops,
# not a kernel, as the counterpart's are XLA ops, not Pallas.


def xz_range_bounds(ranges) -> np.ndarray:
    """IndexRange list -> (R, 4) uint32 rows [lo_hi, lo_lo, hi_hi, hi_lo]."""
    out = np.empty((len(ranges), 4), np.uint32)
    for i, r in enumerate(ranges):
        out[i, 0:2] = _hi_lo(np.uint64(r.lower))
        out[i, 2:4] = _hi_lo(np.uint64(r.upper))
    return out


_NEVER_RANGE = np.array(
    [0xFFFFFFFF, 0xFFFFFFFF, 0, 0], np.uint32
)  # lo = 2^64-1 > hi = 0: matches nothing


def pad_ranges(bounds: np.ndarray, min_r: int = 1) -> np.ndarray:
    """Pad the range axis (last-but-one) to the next power of two (at
    least ``min_r``) with never-matching entries, as the counterpart pads
    its jit shapes."""
    r = bounds.shape[-2]
    cap = max(min_r, bucket_cap(r))
    if cap == r:
        return bounds
    pad_shape = bounds.shape[:-2] + (cap - r, 4)
    return np.concatenate([bounds, np.broadcast_to(_NEVER_RANGE, pad_shape)], axis=-2)


def xz2_query_bounds(
    sfc, xmin: float, ymin: float, xmax: float, ymax: float,
    max_ranges: int = 128,
) -> np.ndarray:
    """(R, 4) uint32 range bounds for one bbox (loose cell semantics: an
    over-covering superset; truncation at max_ranges stays a superset)."""
    return xz_range_bounds(sfc.ranges(xmin, ymin, xmax, ymax, max_ranges=max_ranges))


def xz3_query_bounds(
    sfc,
    xmin: float,
    ymin: float,
    xmax: float,
    ymax: float,
    tmin_ms: int,
    tmax_ms: int,
    max_ranges: int = 128,
) -> "tuple[np.ndarray, np.ndarray]":
    """(bounds (B, R, 4), bin_ids (B,)) for a bbox + absolute-ms window:
    one entry per period bin, partial time extents on edge bins (the xz3
    analog of :func:`z3_query_bounds`); interior whole-period bins share
    one decomposition. Per-bin range lists pad to a common R with
    never-matching entries."""
    mx = max_offset(sfc.period)
    per_bin: list = []
    ids: list = []
    whole_cache = None
    ax, ay = np.array([xmin]), np.array([ymin])
    bx, by = np.array([xmax]), np.array([ymax])
    for b, lo_off, hi_off in bins_for_interval(tmin_ms, tmax_ms, sfc.period):
        whole = lo_off == 0 and hi_off == mx
        if whole and whole_cache is not None:
            rs = whole_cache
        else:
            rs = sfc.ranges(
                ax, ay, np.array([float(lo_off)]), bx, by, np.array([float(hi_off)]),
                max_ranges=max_ranges,
            )
            if whole:
                whole_cache = rs
        per_bin.append(xz_range_bounds(rs))
        ids.append(b)
    if not per_bin:
        return np.zeros((0, 1, 4), np.uint32), np.array([], np.int32)
    r_max = bucket_cap(max(len(p) for p in per_bin))  # the pad_ranges ladder
    stacked = np.stack([pad_ranges(p, min_r=r_max) for p in per_bin])
    return stacked, np.array(ids, np.int32)


def _u64_of(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def _merged(lo: np.ndarray, hi: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Union of inclusive uint64 ranges (lo <= hi) as sorted, disjoint
    (lows, highs) arrays."""
    order = np.argsort(lo, kind="stable")
    lows, highs = [], []
    for a, b in zip(lo[order].tolist(), hi[order].tolist()):
        if highs and a <= highs[-1] + 1:
            highs[-1] = max(highs[-1], b)
        else:
            lows.append(a)
            highs.append(b)
    return np.array(lows, np.uint64), np.array(highs, np.uint64)


_SIGN = np.uint64(1 << 63)


def _ordered_i64(v: np.ndarray) -> np.ndarray:
    """uint64 -> int64 with the order kept (top bit flipped), the keys
    searchsorted compares: 2^64-1 stays the greatest, not -1."""
    return (np.asarray(v, np.uint64) ^ _SIGN).view(np.int64)


def _keys_i64(xz_hi: torch.Tensor, xz_lo: torch.Tensor) -> torch.Tensor:
    """The rows' 64-bit codes, top bit flipped, as int64 (the order of
    :func:`_ordered_i64`)."""
    hi = widen_u32(xz_hi) ^ 0x80000000
    return (hi << 32) | widen_u32(xz_lo)


def _real_ranges(bounds: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(lo, hi) uint64 of the (R, 4) bounds rows that can match (lo <= hi):
    the never-matching padding drops out here."""
    b = np.asarray(bounds, np.uint32).reshape(-1, 4)
    lo, hi = _u64_of(b[:, 0], b[:, 1]), _u64_of(b[:, 2], b[:, 3])
    keep = lo <= hi
    return lo[keep], hi[keep]


class _SortedRanges:
    """Sorted, disjoint inclusive int64 ranges, uploaded once per device;
    ``search`` tells, with one binary search per key, which keys (int64 in
    the ranges' order) fall in one."""

    def __init__(self, lows: np.ndarray, highs: np.ndarray):
        self.lows, self.highs = lows, highs
        self._dev: dict = {}

    def search(self, keys: torch.Tensor) -> torch.Tensor:
        if not len(self.lows):
            return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        t = self._dev.get(keys.device)
        if t is None:
            t = self._dev[keys.device] = (torch.from_numpy(self.lows).to(keys.device),
                                          torch.from_numpy(self.highs).to(keys.device))
        i = torch.searchsorted(t[0], keys, right=True) - 1
        return (i >= 0) & (keys <= t[1][i.clamp(min=0)])


class _XZ2Ranges(_SortedRanges):
    """One unbinned xz query's ranges, merged and sorted once (int64 in
    the order of :func:`_ordered_i64`)."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        lows, highs = _merged(lo, hi)
        super().__init__(_ordered_i64(lows), _ordered_i64(highs))

    def mask(self, xz_hi, xz_lo) -> torch.Tensor:
        return self.search(_keys_i64(xz_hi, xz_lo))


class _XZ3Ranges(_SortedRanges):
    """One binned xz query as a single sorted range list: each entry's
    ranges become composite ranges ``(bin - first) << bits | code`` over
    the bins >= 0 (a negative id is padding and never matches, as in the
    interleaved scan), merged once; a row's key is its bin offset and code
    composed the same way, searched once. Where the composite would pass
    62 bits (never for the ranges of one window at g <= 12), the entries
    are searched one by one."""

    def __init__(self, bounds, bin_ids):
        b = np.asarray(bounds, np.uint32)
        ids = np.asarray(bin_ids, np.int64)
        parts = [(int(ids[e]), *_real_ranges(b[e])) for e in range(len(ids)) if ids[e] >= 0]
        self.parts = [p for p in parts if len(p[1])]
        self.fits = True
        if not self.parts:
            super().__init__(np.zeros(0, np.int64), np.zeros(0, np.int64))
            return
        self.first = min(p[0] for p in self.parts)
        self.span = max(p[0] for p in self.parts) - self.first + 1
        self.max_code = max(int(p[2].max()) for p in self.parts)
        self.bits = max(self.max_code.bit_length(), 1)
        self.fits = self.bits + self.span.bit_length() <= 62
        if not self.fits:
            self.parts = [(bin_id, _XZ2Ranges(lo, hi)) for bin_id, lo, hi in self.parts]
            return
        shift = [np.uint64(p[0] - self.first) << np.uint64(self.bits) for p in self.parts]
        lows, highs = _merged(np.concatenate([s | p[1] for s, p in zip(shift, self.parts)]),
                              np.concatenate([s | p[2] for s, p in zip(shift, self.parts)]))
        super().__init__(lows.view(np.int64), highs.view(np.int64))

    def mask(self, xz_hi, xz_lo, bins) -> torch.Tensor:
        if not self.parts:
            return torch.zeros(xz_hi.shape, dtype=torch.bool, device=xz_hi.device)
        if not self.fits:
            bn = bins.to(torch.int64)
            total = torch.zeros(xz_hi.shape, dtype=torch.bool, device=xz_hi.device)
            for bin_id, ranges in self.parts:
                total |= (bn == bin_id) & ranges.mask(xz_hi, xz_lo)
            return total
        off = bins.to(torch.int64) - self.first
        code = (widen_u32(xz_hi) << 32) | widen_u32(xz_lo)
        # a code past every range's high matches nothing (and must not
        # spill into the next bin's composite space)
        ok = (off >= 0) & (off < self.span) & (code >= 0) & (code <= self.max_code)
        key = torch.where(ok, (off << self.bits) | code, -1)
        return self.search(key) & ok


def xz_range_mask(xz_hi, xz_lo, bounds) -> torch.Tensor:
    """Boolean hit mask for unbinned XZ2 keys; bounds is (R, 4) uint32.
    Equal to the counterpart's any-of-R compare for every bounds array."""
    return _XZ2Ranges(*_real_ranges(bounds)).mask(xz_hi, xz_lo)


def xz3_range_mask(xz_hi, xz_lo, bins, bounds, bin_ids) -> torch.Tensor:
    """Boolean hit mask for binned XZ3 keys: bounds (B, R, 4) uint32
    per-bin ranges, bin_ids (B,) int32. Entries with ``bin_ids < 0`` are
    padding and never match (the counterpart compares padded ids like any
    other, so a row in bin -1 with code 0 would match a padded entry's
    all-zero bounds there)."""
    return _XZ3Ranges(bounds, bin_ids).mask(xz_hi, xz_lo, bins)


def build_xz_scan(bounds: np.ndarray, bin_ids: "np.ndarray | None"):
    """(count_fn, mask_fn) for one loose xz query, the ranges merged once:
    over (xz_hi, xz_lo) for xz2 (``bin_ids`` None), over (bins, xz_hi,
    xz_lo) for xz3, the operand order of the interleaved scan; ``valid=``
    (a bool plane of live rows, None: every row) ANDs in. Torch ops on the
    planes' device; the count is int32."""
    if bin_ids is None:
        ranges = _XZ2Ranges(*_real_ranges(bounds)).mask
    else:
        r3 = _XZ3Ranges(bounds, bin_ids)

        def ranges(bins, xz_hi, xz_lo):
            return r3.mask(xz_hi, xz_lo, bins)

    def mask(*planes, valid=None):
        return kernels.and_valid(ranges(*planes), valid)

    return (lambda *planes, valid=None: mask(*planes, valid=valid).sum(dtype=torch.int32)), mask


def kind_mask_fn(kind: str):
    """Key-plane mask function for an index-key kind: binned kinds take
    (hi, lo, bins, bounds, ids), unbinned (hi, lo, bounds)."""
    return {
        "z3": z3_zscan_mask,
        "z2": z2_zscan_mask,
        "xz3": xz3_range_mask,
        "xz2": xz_range_mask,
    }[kind]


def _check_key_planes(n_dims: int, bins, z_hi, z_lo) -> None:
    planes = [z_hi, z_lo] + ([] if bins is None else [bins])
    if (bins is None) != (n_dims == 2):
        raise ValueError("a binned scan takes the bin plane, an unbinned one does not")
    n, dev = z_hi.shape, z_hi.device
    for p in planes:
        if p.dim() != 1 or p.shape != n or p.device != dev or not p.is_contiguous():
            raise ValueError("key planes must be contiguous 1-D of one length on one device")
    if z_hi.dtype != torch.uint32 or z_lo.dtype != torch.uint32:
        raise TypeError("z_hi/z_lo must be uint32")
    if bins is not None and bins.dtype != torch.int32:
        raise TypeError("the bin plane must be int32")


class _ZScan:
    """One interleaved-scan query: bounds (and bin ids, None for z2)
    checked once, and packed once per device into the uint32 table the
    kernel stages in shared memory: every entry's n_dims * 6 bound words,
    then (binned) the int32 bin-to-entry table of :func:`entry_table`."""

    def __init__(self, bounds, bin_ids):
        self.n_dims = 2 if bin_ids is None else 3
        b = np.ascontiguousarray(bounds, np.uint32)
        if bin_ids is None:
            b = b.reshape(1, *b.shape)
            ids = np.zeros(1, np.int32)
        else:
            ids = np.ascontiguousarray(bin_ids, np.int32)
        if b.shape != (len(ids), self.n_dims, 6):
            raise ValueError(f"bounds {b.shape} do not fit {len(ids)} entries of {self.n_dims} dims")
        if len(ids) > ZSCAN_MAX_ENTRIES:
            raise ValueError(f"{len(ids)} bound entries exceed {ZSCAN_MAX_ENTRIES}")
        self.bounds, self.ids = b, ids
        self.first, self.entry_of = (
            (0, np.zeros(0, np.int32)) if bin_ids is None else entry_table(ids)
        )
        self._table = np.concatenate([b.reshape(-1), self.entry_of.view(np.uint32)])
        self._dev: dict = {}

    def plain(self, bins, z_hi, z_lo, valid=None) -> torch.Tensor:
        if self.n_dims == 2:
            return kernels.and_valid(z2_zscan_mask(z_hi, z_lo, self.bounds[0]), valid)
        return kernels.and_valid(
            z3_zscan_lookup(z_hi, z_lo, bins, self.bounds, self.first, self.entry_of), valid)

    def run(self, bins, z_hi, z_lo, want_mask: bool, valid=None) -> torch.Tensor:
        _check_key_planes(self.n_dims, bins, z_hi, z_lo)
        kernels.check_valid(valid, z_hi.shape[0], z_hi.device)
        if not kernels.on_cuda(z_hi):
            m = self.plain(bins, z_hi, z_lo, valid)
            return m if want_mask else m.sum(dtype=torch.int32)
        return self._launch(bins, z_hi, z_lo, want_mask, valid)

    def _launch(self, bins, z_hi, z_lo, want_mask: bool, valid=None) -> torch.Tensor:
        from geomesa_tpu_torch.kernels import _build

        n = z_hi.shape[0]
        if n > _MAX_ROWS:
            raise ValueError(f"{n} rows exceed the int32 count range")
        planes = [z_hi, z_lo] + ([] if bins is None else [bins])
        if any(p.data_ptr() % 16 for p in planes):
            raise ValueError("key planes must be 16-byte aligned")
        dev = z_hi.device
        tab = self._dev.get(dev)
        if tab is None:
            tab = self._dev[dev] = torch.from_numpy(self._table).to(dev)
        fn = _build.load("zscan").gm_zscan
        with torch.cuda.device(dev):
            out = (
                torch.empty(n, dtype=torch.bool, device=dev)
                if want_mask
                else torch.empty((), dtype=torch.int32, device=dev)
            )
            rc = fn(
                None if bins is None else bins.data_ptr(), z_hi.data_ptr(),
                z_lo.data_ptr(), kernels.valid_ptr(valid), n, tab.data_ptr(), len(self.ids),
                self.first, len(self.entry_of), self.n_dims, int(want_mask), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        name = f"zscan_z{self.n_dims}_{'mask' if want_mask else 'count'}"
        kernels.check_status(rc, name)
        kernels.count_launch(name, valid=valid is not None)
        return out


def batched_kind_mask(kind: str):
    """Plain Q-batched key-plane mask for an index-key kind: the
    single-query mask of :func:`kind_mask_fn` run for each query and
    stacked into (Q, n). Binned kinds take ``(hi, lo, bins, bounds[Q, ...],
    ids[Q, B])``, unbinned ``(hi, lo, bounds[Q, ...])``, as the
    counterpart's vmap does. The interleaved kinds' kernel is
    :func:`batched_zscan_count` / :func:`batched_zscan_mask`; the xz range
    masks are torch ops, as the counterpart's are XLA ops, so this is their
    batched form on any device."""
    mf = kind_mask_fn(kind)
    if kind in ("z3", "xz3"):
        return lambda hi, lo, bins, bounds, ids: torch.stack(
            [mf(hi, lo, bins, b, i) for b, i in zip(bounds, ids)])
    return lambda hi, lo, bounds: torch.stack([mf(hi, lo, b) for b in bounds])


# The batched kernel's table (csrc/zscan.cu gm_zscan_batched): a launch's
# table lives in one block's shared memory, at most 96 KB (two blocks of
# 256 threads an SM); records of 8 (compact) and 24 (masked) words; a
# binned launch of more than FLAT_MAX_RECORDS records adds a bin index.
# Both thresholds below come from tools/zscan_batched_probe.py's A/B of the
# ways: up to 5 records, every row testing every record was no slower than
# the index, count and mask.
BATCH_TABLE_BYTES = 96 * 1024
FLAT_MAX_RECORDS = 5
# Cell boxes stay masked records when no row can meet more than this many
# of the group's records (z2: all of them; z3: those of the row's bin) and
# the group's masked table fits one launch: the de-interleave that compact
# records need costs more than so few masked compares.
MASKED_MAX_MEET = 1
_COMPACT_WORDS, _MASKED_WORDS = 8, 24
# packing keeps every record as [bin, query, ...]; the table holds a compact
# record as [lo0, hi0, lo1, hi1, lo2, hi2, bin, query], one dimension per 8 bytes
_COMPACT_ORDER = [2, 3, 4, 5, 6, 7, 0, 1]


def _u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# each dimension's interleaved bit positions, by number of dimensions
_DIM_MASKS = {
    3: np.array([int(zorder.split_3d_np(zorder.MAX_MASK_3D)) << d for d in range(3)], np.uint64),
    2: np.array([int(zorder.split_2d_np(zorder.MAX_MASK_2D)) << d for d in range(2)], np.uint64),
}


def _compact(v: np.ndarray, n_dims: int) -> np.ndarray:
    """(E, n_dims) uint64 spread bounds -> the de-interleaved coordinates."""
    comb = zorder.combine_3d_np if n_dims == 3 else zorder.combine_2d_np
    return comb(v >> np.arange(n_dims, dtype=np.uint64)).astype(np.uint32)


class _Launch(NamedTuple):
    """One launch of a packed group: queries [q0, q1) (record queries are
    local, q - q0), nc compact and nm masked records, the records' bins in
    [first, first + span), a bin index or not, and the launch's table at
    ``offset`` words of the group's table."""

    q0: int
    q1: int
    nc: int
    nm: int
    first: int
    span: int
    binned: bool
    offset: int
    words: int


class _BatchedZScan:
    """A group of Q interleaved-scan queries, packed once for the batched
    kernel: only the real entries (ids >= 0; none with lo > hi in a
    dimension), as flat lists of records, each with its bin and query.
    Cell-box entries become compact records ``[(lo_d, hi_d) per dimension,
    bin, q]`` of de-interleaved coordinates (``curves/zorder.py``) in 8
    words (z2: the third pair 0), unless ``MASKED_MAX_MEET`` keeps them
    masked; any other entry a masked record ``[bin, q, 0, 0, (mask_hi,
    mask_lo, lo_hi, lo_lo, hi_hi, hi_lo) per dimension]`` of 24 words. Queries are cut into launches whose table fits
    ``BATCH_TABLE_BYTES``; a query with no record answers 0 and starts or
    ends no launch. A binned launch (z3, more than ``FLAT_MAX_RECORDS``
    records) sorts its records by bin and appends the bin index, per bin of
    its span the int32 pair (first compact, first masked record).

    Entries come flat: ``qid`` (E,) query of each entry, ``ids`` (E,) bin
    ids (None for z2), ``bounds`` (E, n_dims, 6) uint32. Each query's ids
    >= 0 must be distinct, at most ``ZSCAN_MAX_ENTRIES`` and span at most
    ``ZSCAN_MAX_SPAN`` bins."""

    def __init__(self, n_dims: int, nq: int, qid, ids, bounds):
        if not 1 <= nq <= MAX_BATCH:
            raise ValueError(f"{nq} queries: a batched launch takes 1 to {MAX_BATCH}")
        b = np.ascontiguousarray(bounds, np.uint32).reshape(-1, n_dims, 6)
        qid = np.asarray(qid, np.int64)
        ids = np.zeros(len(b), np.int64) if ids is None else np.asarray(ids, np.int64)
        if not (len(qid) == len(ids) == len(b)) or (len(qid) and not 0 <= qid.min() <= qid.max() < nq):
            raise ValueError("entries need one query id in [0, Q) and one bin id each")
        self.n_dims, self.nq = n_dims, nq
        real = ids >= 0
        if n_dims == 3:
            _check_query_bins(qid[real], ids[real], nq)
        lo, hi, mask = (_u64(b[:, :, k], b[:, :, k + 1]) for k in (2, 4, 0))
        keep = real & (lo <= hi).all(1)
        dm = _DIM_MASKS[n_dims]
        cell = ((mask == dm) & ((lo & ~dm) == 0) & ((hi & ~dm) == 0)).all(1)
        if keep.any():
            kept = ids[keep]
            meet = np.unique(kept, return_counts=True)[1].max()
            index = _index_words(kept.max() - kept.min() + 1) if n_dims == 3 else 0
            if meet <= MASKED_MAX_MEET and \
                    4 * (_MASKED_WORDS * len(kept) + index) <= BATCH_TABLE_BYTES:
                cell[:] = False
        comp, mskd = keep & cell, keep & ~cell
        nc = int(comp.sum())
        crec = np.zeros((nc, _COMPACT_WORDS), np.int64)
        crec[:, 0], crec[:, 1] = ids[comp], qid[comp]
        lohi = _compact(np.concatenate([lo[comp], hi[comp]]), n_dims)
        crec[:, 2: 2 + 2 * n_dims: 2], crec[:, 3: 3 + 2 * n_dims: 2] = lohi[:nc], lohi[nc:]
        mrec = np.zeros((int(mskd.sum()), _MASKED_WORDS), np.int64)
        mrec[:, 0], mrec[:, 1] = ids[mskd], qid[mskd]
        mrec[:, 4: 4 + 6 * n_dims] = b[mskd].reshape(-1, 6 * n_dims)
        self.launches, tables = self._cut(crec, mrec)
        self.table = (np.concatenate(tables) if tables else np.zeros(0, np.int64)) \
            .astype(np.uint32)
        covered = np.zeros(nq, bool)
        for lc in self.launches:
            covered[lc.q0: lc.q1] = True
        self.idle = np.nonzero(~covered)[0]  # queries no launch answers: 0
        self._dev: dict = {}

    def _cut(self, crec: np.ndarray, mrec: np.ndarray):
        """The launches and their tables: from each query with records, as
        many queries as fit one table."""
        nq, binned_kind = self.nq, self.n_dims == 3
        ncq = np.bincount(crec[:, 1], minlength=nq)
        nmq = np.bincount(mrec[:, 1], minlength=nq)
        recs = ncq + nmq
        nbytes = 4 * (_COMPACT_WORDS * ncq + _MASKED_WORDS * nmq)
        bins = np.concatenate([crec[:, 0], mrec[:, 0]])
        qs = np.concatenate([crec[:, 1], mrec[:, 1]])
        qmin = np.full(nq, np.iinfo(np.int64).max)
        qmax = np.full(nq, np.iinfo(np.int64).min)
        np.minimum.at(qmin, qs, bins)
        np.maximum.at(qmax, qs, bins)
        launches, tables, offset, q0 = [], [], 0, 0
        while True:
            todo = np.nonzero(recs[q0:])[0]
            if not len(todo):
                return launches, tables
            q0 += int(todo[0])
            n_rec = np.cumsum(recs[q0:])
            span = np.maximum.accumulate(qmax[q0:]) - np.minimum.accumulate(qmin[q0:]) + 1
            binned = binned_kind & (n_rec > FLAT_MAX_RECORDS)
            index = np.where(binned, 4 * _index_words(span), 0)
            fits = np.cumsum(nbytes[q0:]) + index <= BATCH_TABLE_BYTES
            k = len(fits) if fits.all() else int(np.argmin(fits))
            q1 = q0 + int(np.nonzero(recs[q0: q0 + max(k, 1)])[0][-1]) + 1
            table, lc = self._table(crec, mrec, q0, q1, bool(binned[q1 - q0 - 1]), offset)
            launches.append(lc)
            tables.append(table)
            offset += lc.words
            q0 = q1

    def _table(self, crec, mrec, q0: int, q1: int, binned: bool, offset: int):
        c = crec[(crec[:, 1] >= q0) & (crec[:, 1] < q1)]
        m = mrec[(mrec[:, 1] >= q0) & (mrec[:, 1] < q1)]
        c[:, 1] -= q0
        m[:, 1] -= q0
        bins = np.concatenate([c[:, 0], m[:, 0]])
        first, span = int(bins.min()), int(bins.max() - bins.min()) + 1
        parts = []
        if binned:
            c = c[np.lexsort((c[:, 1], c[:, 0]))]
            m = m[np.lexsort((m[:, 1], m[:, 0]))]
            edges = np.arange(span + 1)
            index = np.zeros(_index_words(span), np.int64)
            index[0: 2 * (span + 1): 2] = np.searchsorted(c[:, 0] - first, edges)
            index[1: 2 * (span + 1): 2] = np.searchsorted(m[:, 0] - first, edges)
            parts = [index]
        table = np.concatenate([c[:, _COMPACT_ORDER].reshape(-1), m.reshape(-1)] + parts)
        if len(table) * 4 > BATCH_TABLE_BYTES:  # one query's records alone
            raise ValueError(f"a query's table of {4 * len(table)} B exceeds {BATCH_TABLE_BYTES} B")
        return table, _Launch(q0, q1, len(c), len(m), first, span, binned, offset, len(table))

    def _records(self, lc: _Launch):
        """(compact (nc, 8), masked (nm, 24), bin index (span + 1, 2) or
        None) of a launch, read back from the packed table."""
        t = self.table[lc.offset: lc.offset + lc.words]
        nc, nm = _COMPACT_WORDS * lc.nc, _MASKED_WORDS * lc.nm
        c = t[:nc].reshape(-1, _COMPACT_WORDS)
        m = t[nc: nc + nm].reshape(-1, _MASKED_WORDS)
        index = t[nc + nm: nc + nm + 2 * (lc.span + 1)].view(np.int32).reshape(-1, 2) \
            if lc.binned else None
        return c, m, index

    def plain(self, bins, z_hi, z_lo, valid=None) -> torch.Tensor:
        """Plain PyTorch version on the packed layout: the (Q, n) bool
        masks, each launch's records read from its table and, binned, found
        through its bin index; the keys de-interleaved by
        ``curves/zorder.py``; every row ANDed with ``valid``. Equal to
        :func:`batched_kind_mask`, the semantic reference, for entries the
        packer takes."""
        n, dev = z_hi.shape[0], z_hi.device
        out = torch.zeros((self.nq, n), dtype=torch.bool, device=dev)
        if not self.launches:
            return out
        decode = zorder.decode_3d_hi_lo_t if self.n_dims == 3 else zorder.decode_2d_hi_lo_t
        coords = decode(z_hi, z_lo)
        zh, zl = widen_u32(z_hi), widen_u32(z_lo)
        bn = torch.zeros(n, dtype=torch.int64, device=dev) if bins is None else bins.to(torch.int64)

        def compact_hit(rec):
            hit = None
            for d in range(self.n_dims):
                h = (coords[d] >= int(rec[2 * d])) & (coords[d] <= int(rec[2 * d + 1]))
                hit = h if hit is None else hit & h
            return hit

        def masked_hit(rec):
            return _dims_mask(zh, zl, rec[4: 4 + 6 * self.n_dims].reshape(self.n_dims, 6),
                              self.n_dims)

        for lc in self.launches:
            c, m, index = self._records(lc)
            groups = [(np.arange(len(c)), np.arange(len(m)), None)]
            if index is not None:  # per bin of the span that has records
                groups = [(np.arange(index[i, 0], index[i + 1, 0]),
                           np.arange(index[i, 1], index[i + 1, 1]), lc.first + i)
                          for i in np.nonzero(np.any(np.diff(index, axis=0) > 0, axis=1))[0]]
            for cs, ms, bin_id in groups:
                for recs, (at_bin, at_q), hit in ((c[cs], (6, 7), compact_hit),
                                                  (m[ms], (0, 1), masked_hit)):
                    for rec in recs:
                        b = int(rec[at_bin]) if bin_id is None else bin_id
                        out[lc.q0 + int(rec[at_q])] |= (bn == b) & hit(rec)
        return kernels.and_valid(out, valid)

    def run(self, bins, z_hi, z_lo, want_mask: bool, valid=None) -> torch.Tensor:
        _check_key_planes(self.n_dims, bins, z_hi, z_lo)
        kernels.check_valid(valid, z_hi.shape[0], z_hi.device)
        if not kernels.on_cuda(z_hi):
            m = self.plain(bins, z_hi, z_lo, valid)
            return m if want_mask else m.sum(dim=1, dtype=torch.int32)
        return self._launch(bins, z_hi, z_lo, want_mask, valid)

    def device_table(self, dev) -> torch.Tensor:
        """The packed table on ``dev``, uploaded once (see :func:`_upload`)."""
        t = self._dev.get(dev)
        if t is None:
            t = self._dev[dev] = _upload(self.table, dev)
        return t

    def _launch(self, bins, z_hi, z_lo, want_mask: bool, valid=None) -> torch.Tensor:
        from geomesa_tpu_torch.kernels import _build

        n = z_hi.shape[0]
        if n > _MAX_ROWS:
            raise ValueError(f"{n} rows exceed the int32 count range")
        planes = [z_hi, z_lo] + ([] if bins is None else [bins])
        if any(p.data_ptr() % 16 for p in planes):
            raise ValueError("key planes must be 16-byte aligned")
        vptr = kernels.valid_ptr(valid)
        dev = z_hi.device
        name = f"zscan_batched_z{self.n_dims}_{'mask' if want_mask else 'count'}"
        with torch.cuda.device(dev):
            if want_mask:
                out = torch.empty((self.nq, n), dtype=torch.bool, device=dev)
                for q in self.idle:
                    out[int(q)].zero_()
            else:
                make = torch.zeros if len(self.idle) else torch.empty
                out = make(self.nq, dtype=torch.int32, device=dev)
            if not self.launches:
                return out
            tab = self.device_table(dev)
            fn = _build.load("zscan").gm_zscan_batched
            stream = torch.cuda.current_stream(dev).cuda_stream
            for lc in self.launches:
                rc = fn(
                    None if bins is None else bins.data_ptr(), z_hi.data_ptr(),
                    z_lo.data_ptr(), vptr, n, tab.data_ptr() + 4 * lc.offset, lc.words,
                    lc.q1 - lc.q0, lc.nc, lc.nm, lc.first, lc.span, int(lc.binned),
                    self.n_dims, int(want_mask),
                    out.data_ptr() + (lc.q0 * n if want_mask else 4 * lc.q0), stream,
                )
                kernels.check_status(rc, name)
                kernels.count_launch(name, q=lc.q1 - lc.q0, valid=valid is not None)
        return out


def _index_words(span):
    """Words of a bin index over ``span`` bins: span + 1 int32 pairs,
    padded to a multiple of 4 (16-byte records and loads)."""
    return (2 * (np.asarray(span) + 1) + 3) // 4 * 4


def _check_query_bins(qid: np.ndarray, ids: np.ndarray, nq: int) -> None:
    """Each query's real ids: distinct, at most ZSCAN_MAX_ENTRIES, over at
    most ZSCAN_MAX_SPAN bins."""
    if not len(ids):
        return
    order = np.lexsort((ids, qid))
    q, i = qid[order], ids[order]
    if np.any((q[1:] == q[:-1]) & (i[1:] == i[:-1])):
        raise ValueError("a query's bound entries share a bin")
    if np.bincount(qid, minlength=nq).max() > ZSCAN_MAX_ENTRIES:
        raise ValueError(f"a query has more than {ZSCAN_MAX_ENTRIES} bound entries")
    lo = np.full(nq, np.iinfo(np.int64).max)
    hi = np.full(nq, np.iinfo(np.int64).min)
    np.minimum.at(lo, qid, ids)
    np.maximum.at(hi, qid, ids)
    used = lo <= hi
    if np.any(hi[used] - lo[used] + 1 > ZSCAN_MAX_SPAN):
        raise ValueError(f"a query's bound entries span more than {ZSCAN_MAX_SPAN} bins")


def batched_zscan(bounds, bin_ids) -> _BatchedZScan:
    """Pack a group given as stacked arrays: z3 bounds (Q, B, 3, 6) with ids
    (Q, B), -1 for padding; z2 bounds (Q, 2, 6) with ids None."""
    b = np.ascontiguousarray(bounds, np.uint32)
    nq = b.shape[0] if b.ndim else 0
    if not 1 <= nq <= MAX_BATCH:
        raise ValueError(f"{nq} queries: a batched launch takes 1 to {MAX_BATCH}")
    if bin_ids is None:
        if b.shape != (nq, 2, 6):
            raise ValueError(f"z2 bounds {b.shape} are not (Q, 2, 6)")
        return _BatchedZScan(2, nq, np.arange(nq), None, b)
    ids = np.ascontiguousarray(bin_ids, np.int32)
    if ids.ndim != 2 or b.shape != (nq, ids.shape[1], 3, 6) or not ids.shape[1]:
        raise ValueError(f"bounds {b.shape} and ids {ids.shape} are not (Q, B, 3, 6), (Q, B)")
    if ids.shape[1] > ZSCAN_MAX_ENTRIES:
        raise ValueError(f"{ids.shape[1]} bound entries exceed {ZSCAN_MAX_ENTRIES}")
    qid = np.repeat(np.arange(nq), ids.shape[1])
    return _BatchedZScan(3, nq, qid, ids.reshape(-1), b.reshape(-1, 3, 6))


def batched_zscan_group(bounds: list, bin_ids: "list | None") -> _BatchedZScan:
    """Pack a group given query by query, as the fused loose paths hold it:
    z3 a list of (B_q, 3, 6) bounds and of (B_q,) ids; z2 a list of (2, 6)
    bounds and ids None. Nothing is padded."""
    nq = len(bounds)
    if not 1 <= nq <= MAX_BATCH:
        raise ValueError(f"{nq} queries: a batched launch takes 1 to {MAX_BATCH}")
    if bin_ids is None:
        return _BatchedZScan(2, nq, np.arange(nq), None, np.stack(bounds))
    if len(bin_ids) != nq or any(len(b) != len(i) for b, i in zip(bounds, bin_ids)):
        raise ValueError("each query needs one bounds row per bin id")
    qid = np.repeat(np.arange(nq), [len(i) for i in bin_ids])
    return _BatchedZScan(3, nq, qid, np.concatenate(bin_ids), np.concatenate(bounds))


def batched_zscan_count(bounds, bin_ids, z_hi, z_lo, bins=None, valid=None) -> torch.Tensor:
    """(Q,) int32 hit counts of Q interleaved-scan queries in one pass over
    the key planes (one launch per table that fits, see
    :class:`_BatchedZScan`): z3 with (Q, B, 3, 6) bounds, (Q, B) ids (-1:
    padding, never matches) and the bin plane; z2 with (Q, 2, 6) bounds,
    ids and bins None. Each query's ids >= 0 must be distinct and span at
    most ``ZSCAN_MAX_SPAN`` bins; ``valid`` (None: every row) marks the
    live rows. The kernel ``gm_zscan_batched`` for CUDA planes,
    :meth:`_BatchedZScan.plain` for CPU planes."""
    return batched_zscan(bounds, bin_ids).run(bins, z_hi, z_lo, want_mask=False, valid=valid)


def batched_zscan_mask(bounds, bin_ids, z_hi, z_lo, bins=None, valid=None) -> torch.Tensor:
    """(Q, n) bool hit masks, row q for query q, False on dead rows;
    arguments and routing as :func:`batched_zscan_count`."""
    return batched_zscan(bounds, bin_ids).run(bins, z_hi, z_lo, want_mask=True, valid=valid)


def build_z3_pallas_scan(bounds: np.ndarray, bin_ids: np.ndarray):
    """(count_fn, mask_fn) over (bins int32, z_hi uint32, z_lo uint32)
    interleaved key planes for one binned query: (B, 3, 6) uint32 bounds
    and (B,) int32 bin ids, -1 for padding. CUDA planes launch the kernel
    of ``csrc/zscan.cu`` (bounds are runtime data: one build serves every
    window), CPU planes take :func:`z3_zscan_lookup` (the kernel's table
    layout; :func:`z3_zscan_mask` is the semantic reference). The ids >= 0
    must be distinct and span at most ``ZSCAN_MAX_SPAN`` bins, as one
    window's bins do. The count is int32; ``valid=`` (None: every row)
    marks the live rows."""
    q = _ZScan(bounds, bin_ids)
    return (
        lambda bins, z_hi, z_lo, valid=None: q.run(bins, z_hi, z_lo, False, valid),
        lambda bins, z_hi, z_lo, valid=None: q.run(bins, z_hi, z_lo, True, valid),
    )


def build_z2_zscan(bounds: np.ndarray):
    """(count_fn, mask_fn) over (z_hi, z_lo) unbinned Z2 key planes for
    (2, 6) uint32 bounds; routing as :func:`build_z3_pallas_scan`, plain
    version :func:`z2_zscan_mask`."""
    q = _ZScan(bounds, None)
    return (
        lambda z_hi, z_lo, valid=None: q.run(None, z_hi, z_lo, False, valid),
        lambda z_hi, z_lo, valid=None: q.run(None, z_hi, z_lo, True, valid),
    )
