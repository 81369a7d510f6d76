"""Resident key-plane scans: the de-interleaved dim planes and the
interleaved masked-compare planes, with their query builders, kernel
wrappers and plain PyTorch versions.

Counterpart of ``geomesa_tpu/ops/zscan.py`` for the point kinds (z3, z2).

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

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.bucketing import bucket_cap
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.binnedtime import bins_for_interval
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


def dimscan_plain(qarr: np.ndarray, nx, ny, bt=None) -> torch.Tensor:
    """Plain PyTorch version of the dim scan: the bool hit mask. Unsigned
    words are widened to int64 (torch has no ordered uint32 compares)."""
    q = [int(v) for v in np.asarray(qarr, np.uint32)]
    a, b = widen_u32(nx), widen_u32(ny)
    m = (a >= q[0]) & (a <= q[1]) & (b >= q[2]) & (b <= q[3])
    if bt is not None:
        t = widen_u32(bt)
        tm = torch.zeros_like(m)
        for k in range((len(q) - 4) // 2):
            tm |= (t >= q[4 + 2 * k]) & (t <= q[5 + 2 * k])
        m &= tm
    return m


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


def _launch_dimscan(qarr, planes, want_mask: bool) -> torch.Tensor:
    from geomesa_tpu_torch.kernels import _build

    r = _check_dim_args(qarr, planes)
    nx = planes[0]
    n = nx.shape[0]
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 count range")
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError("dim-scan planes must be 16-byte aligned")
    lib = _build.load("dimscan")
    fn = lib.gm_dimscan
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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
            bt.data_ptr() if bt is not None else None,
            n, q.ctypes.data, r, int(want_mask), out.data_ptr(),
            torch.cuda.current_stream(nx.device).cuda_stream,
        )
    name = f"dimscan_{'z3' if bt is not None else 'z2'}_{'mask' if want_mask else 'count'}"
    kernels.check_status(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def dimscan_count(qarr: np.ndarray, nx, ny, bt=None) -> torch.Tensor:
    """int32 hit count of the dim scan (z3 with ``bt``, z2 without): the
    CUDA kernel for CUDA planes, the plain version for CPU planes."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan(qarr, planes, want_mask=False)
    _check_dim_args(qarr, planes)
    return dimscan_plain(qarr, nx, ny, bt).sum(dtype=torch.int32)


def dimscan_mask(qarr: np.ndarray, nx, ny, bt=None) -> torch.Tensor:
    """bool hit mask of the dim scan; routing as :func:`dimscan_count`."""
    planes = (nx, ny) if bt is None else (nx, ny, bt)
    if kernels.on_cuda(nx):
        return _launch_dimscan(qarr, planes, want_mask=True)
    _check_dim_args(qarr, planes)
    return dimscan_plain(qarr, nx, ny, bt)


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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
    kernels.LAUNCHES[name] += 1
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

ZSCAN_MAX_ENTRIES = 512  # bound entries a kernel launch stages in shared memory


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


def z2_zscan_mask(z_hi, z_lo, bounds) -> torch.Tensor:
    """Plain PyTorch version of the unbinned Z2 interleaved scan;
    ``bounds`` is (2, 6) uint32."""
    return _dims_mask(widen_u32(z_hi), widen_u32(z_lo), np.asarray(bounds, np.uint32), 2)


def kind_mask_fn(kind: str):
    """Key-plane mask function for an index-key kind: binned kinds take
    (hi, lo, bins, bounds, ids), unbinned (hi, lo, bounds)."""
    fns = {"z3": z3_zscan_mask, "z2": z2_zscan_mask}
    if kind in ("xz3", "xz2"):
        raise NotImplementedError(
            f"{kind} range masks are a later port slice (ROADMAP, port queue: "
            "interleaved-layout and xz scans, the xz kinds)"
        )
    return fns[kind]


class _ZScan:
    """One interleaved-scan query: bounds (and bin ids, None for z2)
    checked once, and packed once per device into the uint32 table the
    kernel stages in shared memory: every entry's n_dims * 6 bound words,
    then the entries' int32 ids."""

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
        self._table = np.concatenate([b.reshape(-1), ids.view(np.uint32)])
        self._dev: dict = {}

    def plain(self, bins, z_hi, z_lo) -> torch.Tensor:
        if self.n_dims == 2:
            return z2_zscan_mask(z_hi, z_lo, self.bounds[0])
        return z3_zscan_mask(z_hi, z_lo, bins, self.bounds, self.ids)

    def _check(self, bins, z_hi, z_lo) -> None:
        planes = [z_hi, z_lo] + ([] if bins is None else [bins])
        if (bins is None) != (self.n_dims == 2):
            raise ValueError("a binned scan takes the bin plane, an unbinned one does not")
        n, dev = z_hi.shape, z_hi.device
        for p in planes:
            if p.dim() != 1 or p.shape != n or p.device != dev or not p.is_contiguous():
                raise ValueError("key planes must be contiguous 1-D of one length on one device")
        if z_hi.dtype != torch.uint32 or z_lo.dtype != torch.uint32:
            raise TypeError("z_hi/z_lo must be uint32")
        if bins is not None and bins.dtype != torch.int32:
            raise TypeError("the bin plane must be int32")

    def run(self, bins, z_hi, z_lo, want_mask: bool) -> torch.Tensor:
        self._check(bins, z_hi, z_lo)
        if not kernels.on_cuda(z_hi):
            m = self.plain(bins, z_hi, z_lo)
            return m if want_mask else m.sum(dtype=torch.int32)
        return self._launch(bins, z_hi, z_lo, want_mask)

    def _launch(self, bins, z_hi, z_lo, want_mask: bool) -> torch.Tensor:
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
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            out = (
                torch.empty(n, dtype=torch.bool, device=dev)
                if want_mask
                else torch.empty((), dtype=torch.int32, device=dev)
            )
            rc = fn(
                None if bins is None else bins.data_ptr(), z_hi.data_ptr(),
                z_lo.data_ptr(), n, tab.data_ptr(), len(self.ids), self.n_dims,
                int(want_mask), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        name = f"zscan_z{self.n_dims}_{'mask' if want_mask else 'count'}"
        kernels.check_status(rc, name)
        kernels.LAUNCHES[name] += 1
        return out


def build_z3_pallas_scan(bounds: np.ndarray, bin_ids: np.ndarray):
    """(count_fn, mask_fn) over (bins int32, z_hi uint32, z_lo uint32)
    interleaved key planes for one binned query: (B, 3, 6) uint32 bounds
    and (B,) int32 bin ids, -1 for padding. CUDA planes launch the kernel
    of ``csrc/zscan.cu`` (bounds are runtime data: one build serves every
    window), CPU planes take :func:`z3_zscan_mask`. The count is int32."""
    q = _ZScan(bounds, bin_ids)
    return (
        lambda bins, z_hi, z_lo: q.run(bins, z_hi, z_lo, want_mask=False),
        lambda bins, z_hi, z_lo: q.run(bins, z_hi, z_lo, want_mask=True),
    )


def build_z2_zscan(bounds: np.ndarray):
    """(count_fn, mask_fn) over (z_hi, z_lo) unbinned Z2 key planes for
    (2, 6) uint32 bounds; routing as :func:`build_z3_pallas_scan`, plain
    version :func:`z2_zscan_mask`."""
    q = _ZScan(bounds, None)
    return (
        lambda z_hi, z_lo: q.run(None, z_hi, z_lo, want_mask=False),
        lambda z_hi, z_lo: q.run(None, z_hi, z_lo, want_mask=True),
    )
