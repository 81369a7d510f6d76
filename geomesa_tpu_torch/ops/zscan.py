"""De-interleaved key-plane scans: packing, query vectors, and the dim-scan
kernel wrappers with their plain PyTorch versions.

Counterpart of the dim-plane half of ``geomesa_tpu/ops/zscan.py``. Morton
order exists for sorting; a resident scan keeps the SAME key
de-interleaved -- nx, ny uint32 planes plus ONE packed bt word
((bin - bin_base) << 21 | nt) -- and answers the cell-granular loose query
with a few compares per row. Contiguous query bins merge into one bt
range, so a multi-week window costs 2 compares, not 2 per bin.

The kernels (``csrc/dimscan.cu``) replace ``build_z3_dimscan_rt`` and
``build_z2_dimscan_rt``. The wrappers below launch them for CUDA tensors
and use the plain versions only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.bucketing import bucket_cap
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
    if sfc.precision != BT_TIME_BITS:
        return None
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
    n = planes[0].shape
    dev = planes[0].device
    for p in planes:
        if p.dtype != torch.uint32 or p.dim() != 1 or p.shape != n:
            raise TypeError("dim-scan planes must be 1-D uint32 of one length")
        if p.device != dev or not p.is_contiguous():
            raise ValueError("dim-scan planes must be contiguous on one device")
    return r


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
