"""Density rasterization: pixel ids, the density kernel wrapper and its
plain PyTorch version.

Counterpart of ``geomesa_tpu/ops/density_pallas.py`` (whole) and of
``_pixel_ids`` in ``geomesa_tpu/process/density.py:109``. The kernel
(``csrc/density.cu``) replaces ``build_density_pallas`` and also the XLA
scatter engine the counterpart keeps for grids past 512x512: the split is
a TPU limit (VMEM holds the accumulator and the one-hot width), so one
kernel serves every grid here.

Precision. The pixel math runs in float64 on float32 coordinates widened
exactly: the counterpart's tests run on the CPU under x64, where the
viewport and the staged coordinates are float64 and ``_pixel_ids`` runs
in float64, so f32-exact data lands in the reference's pixels bit for
bit, border pixels included. On a TPU the counterpart computes the same
pixels in float32 (its host reference ``density_pallas.density_oracle``),
and border pixels can differ from this port's; the port
follows the reference it is tested against. The scale factors
``sx = width / (xmax - xmin)`` are computed on the host in Python float64,
as ``_pixel_ids`` does. Unweighted grids count in int32 (exact) and come
back as float32, as the Pallas kernel's int32 accumulator does. Weighted
grids sum float32 weights in float64 and come back as float32; the order
of the sum depends on the run, so they match the counterpart within
rtol 2e-5 / atol 1e-3 (its own bound) and the plain version within
rtol 1e-6.

:func:`density_grid` launches the kernel for CUDA tensors and uses
:func:`density_plain` only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from geomesa_tpu_torch import kernels

MAX_CELLS = 2**31 - 1  # flat cell ids are int32 in the kernel


def viewport(env, width: int, height: int) -> tuple:
    """(xmin, ymin, xmax, ymax, sx, sy) in Python float64 for an
    Envelope or a (xmin, ymin, xmax, ymax) 4-vector."""
    if hasattr(env, "xmin"):
        xmin, ymin, xmax, ymax = env.xmin, env.ymin, env.xmax, env.ymax
    else:
        xmin, ymin, xmax, ymax = env
    xmin, ymin, xmax, ymax = (float(v) for v in (xmin, ymin, xmax, ymax))
    if not (xmax > xmin and ymax > ymin):
        raise ValueError(f"viewport {(xmin, ymin, xmax, ymax)} has no area")
    return xmin, ymin, xmax, ymax, width / (xmax - xmin), height / (ymax - ymin)


def pixel_ids(x: torch.Tensor, y: torch.Tensor, env, width: int, height: int):
    """(px, py, inside): int32 pixel columns and rows, clipped to the grid,
    and the viewport test, all in float64 (``_pixel_ids`` under x64)."""
    xmin, ymin, xmax, ymax, sx, sy = viewport(env, width, height)
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    px = torch.clamp(torch.floor((xd - xmin) * sx), 0, width - 1).to(torch.int32)
    py = torch.clamp(torch.floor((yd - ymin) * sy), 0, height - 1).to(torch.int32)
    inside = (xd >= xmin) & (xd <= xmax) & (yd >= ymin) & (yd <= ymax)
    return px, py, inside


def density_plain(x, y, env, width: int, height: int, mask=None, weights=None) -> torch.Tensor:
    """Plain PyTorch version of the density kernel: float64 pixel ids,
    then ``index_add_`` into an int64 (count) or float64 (weight) grid;
    returns the (height, width) float32 grid."""
    px, py, inside = pixel_ids(x, y, env, width, height)
    keep = inside if mask is None else inside & mask
    flat = (py.to(torch.int64) * width + px.to(torch.int64))[keep]
    if weights is None:
        grid = torch.zeros(width * height, dtype=torch.int64, device=x.device)
        grid.index_add_(0, flat, torch.ones_like(flat))
    else:
        w = weights.to(torch.float32).to(torch.float64)[keep]
        grid = torch.zeros(width * height, dtype=torch.float64, device=x.device)
        grid.index_add_(0, flat, w)
    return grid.to(torch.float32).reshape(height, width)


def _check(x, y, width, height, mask, weights) -> None:
    if width < 1 or height < 1 or width * height > MAX_CELLS:
        raise ValueError(f"a {width}x{height} grid is outside 1..{MAX_CELLS} cells")
    n = x.shape
    for name, t, dtypes in (
        ("x", x, (torch.float32,)),
        ("y", y, (torch.float32,)),
        ("mask", mask, (torch.bool,)),
        ("weights", weights, (torch.float32, torch.int32)),
    ):
        if t is None:
            continue
        if t.dtype not in dtypes:
            raise TypeError(f"density {name}: {t.dtype}, expected one of {dtypes}")
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"density {name}: shape {tuple(t.shape)} != {tuple(n)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"density {name} must be contiguous on {x.device}")


def _launch(x, y, env, width, height, mask, weights, shared: bool = True) -> torch.Tensor:
    """Launch the kernel (none for 0 rows: the grid stays zero).
    ``shared=False`` keeps a grid that fits shared memory on the global
    engine, so that the two engines can be timed on one grid."""
    from geomesa_tpu_torch.kernels import _build

    view = viewport(env, width, height)
    lib = _build.load("density")
    fn = lib.gm_density
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_double] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    dev = x.device
    n = int(x.shape[0])
    with torch.cuda.device(dev):
        w = None if weights is None else weights.to(torch.float32)
        acc = torch.zeros(
            width * height,
            dtype=torch.int32 if w is None else torch.float64,
            device=dev,
        )
        if n:
            rc = fn(
                x.data_ptr(), y.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if w is None else w.data_ptr(),
                n, *view, width, height, int(shared), acc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            name = "density_count" if weights is None else "density_weighted"
            kernels.check_status(rc, name)
            kernels.LAUNCHES[name] += 1
    return acc.to(torch.float32).reshape(height, width)


def density_grid(x, y, env, width: int, height: int, mask=None, weights=None) -> torch.Tensor:
    """(height, width) float32 grid of the rows that are masked in (``mask``
    None: every row) and inside the viewport ``env``: their count, or the
    sum of their ``weights`` (float32, or int32 cast to float32 as the
    counterpart's ``astype(float32)`` does). The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(x, y, width, height, mask, weights)
    if kernels.on_cuda(x):
        return _launch(x, y, env, width, height, mask, weights)
    return density_plain(x, y, env, width, height, mask, weights)
