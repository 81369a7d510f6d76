"""Density rasterization: pixel ids, the density kernel wrapper and its
plain PyTorch version.

Counterpart of ``geomesa_tpu/ops/density_pallas.py`` (whole) and of
``_pixel_ids`` in ``geomesa_tpu/process/density.py:109``. The kernel
(``csrc/density.cu``) replaces ``build_density_pallas`` and also the XLA
scatter engine the counterpart keeps for grids past 512x512: that split is
a TPU limit (VMEM holds the accumulator and the one-hot width). Here the
kernel has two engines of its own, chosen by grid size and kind
(:func:`engine_for`): counted grids of at most 2^18 cells in the shared
memory of a thread-block cluster, every other grid through a per-block
table of hot cells (``csrc/density.cu`` says why).

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

import torch

from geomesa_tpu_torch import kernels

MAX_CELLS = 2**31 - 1  # flat cell ids are int32 in the kernel


def corners(env) -> tuple:
    """(xmin, ymin, xmax, ymax) as Python floats from an Envelope or a
    4-vector."""
    if hasattr(env, "xmin"):
        env = (env.xmin, env.ymin, env.xmax, env.ymax)
    return tuple(float(v) for v in env)


def inverted(env) -> bool:
    """True for a viewport with xmax < xmin or ymax < ymin: no row lies
    inside it (a map tile across the antimeridian is one)."""
    xmin, ymin, xmax, ymax = corners(env)
    return xmax < xmin or ymax < ymin


def viewport(env, width: int, height: int, lines: bool = False) -> tuple:
    """(xmin, ymin, xmax, ymax, sx, sy) in Python float64 for an
    Envelope or a (xmin, ymin, xmax, ymax) 4-vector.

    A viewport without area raises, unless ``lines`` is set and no axis
    is inverted: then an axis of zero extent gets the scale 0, so the
    rows on its line land in cell 0 of that axis. That is where the
    counterpart's resident path puts them: its scale is ``width / 0``,
    the pixel coordinate of a row on the line ``0 * inf`` = NaN, and
    NaN converts to pixel 0."""
    xmin, ymin, xmax, ymax = corners(env)
    if not (xmax > xmin and ymax > ymin):
        if not (lines and xmax >= xmin and ymax >= ymin):
            raise ValueError(f"viewport {(xmin, ymin, xmax, ymax)} has no area")
    sx = width / (xmax - xmin) if xmax > xmin else 0.0
    sy = height / (ymax - ymin) if ymax > ymin else 0.0
    return xmin, ymin, xmax, ymax, sx, sy


def pixel_ids(x: torch.Tensor, y: torch.Tensor, env, width: int, height: int,
              lines: bool = False):
    """(px, py, inside): int32 pixel columns and rows, clipped to the grid,
    and the viewport test, all in float64 (``_pixel_ids`` under x64);
    ``lines`` as in :func:`viewport`."""
    xmin, ymin, xmax, ymax, sx, sy = viewport(env, width, height, lines)
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    px = torch.clamp(torch.floor((xd - xmin) * sx), 0, width - 1).to(torch.int32)
    py = torch.clamp(torch.floor((yd - ymin) * sy), 0, height - 1).to(torch.int32)
    inside = (xd >= xmin) & (xd <= xmax) & (yd >= ymin) & (yd <= ymax)
    return px, py, inside


def density_plain(x, y, env, width: int, height: int, mask=None, weights=None,
                  lines: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the density kernel: float64 pixel ids,
    then ``index_add_`` into an int64 (count) or float64 (weight) grid;
    returns the (height, width) float32 grid. Only the weights of rows
    that count enter the sum, so a non-finite weight elsewhere changes
    nothing."""
    px, py, inside = pixel_ids(x, y, env, width, height, lines)
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


# the cluster engine: counted grids of at most 2^18 cells, in slices of at
# most 2^15 int32 cells (128 KB) per CTA of a cluster of 1, 2, 4 or 8
CLUSTER_MAX_CELLS = 1 << 18
SLICE_CELLS = 1 << 15
_ENGINE_IDS = {"cluster": 1, "hotcell": 2}
_SMEM_CELLS = 227 * 1024 // 4  # int32 cells one CTA's shared memory holds


def engine_for(width: int, height: int, weighted: bool) -> tuple:
    """The kernel's engine for a grid, by size and kind alone:
    ``("cluster", C)`` for counted grids of at most 2^18 cells (C the
    fewest CTAs whose slices hold them), else ``("hotcell", 0)``."""
    cells = width * height
    if weighted or cells > CLUSTER_MAX_CELLS:
        return ("hotcell", 0)
    c = 1
    while cells > SLICE_CELLS * c:
        c *= 2
    return ("cluster", c)


def engines(width: int, height: int, weighted: bool) -> list:
    """Every engine that can take a grid: the cluster engine at each
    cluster size whose shared memory holds the grid (counts only), and the
    hot-cell engine."""
    cells = width * height
    fits = [] if weighted else [
        ("cluster", c) for c in (1, 2, 4, 8)
        if cells <= (_SMEM_CELLS if c == 1 else SLICE_CELLS * c)]
    return fits + [("hotcell", 0)]


def _launch(x, y, env, width, height, mask, weights, engine=None,
            lines: bool = False) -> torch.Tensor:
    """Launch the kernel (none for 0 rows: the grid stays zero) on the
    engine :func:`engine_for` picks, or on ``engine`` (``("cluster", C)``
    or ``("hotcell", 0)``), which only a timing or check of one engine
    passes."""
    from geomesa_tpu_torch.kernels import _build

    view = viewport(env, width, height, lines)
    weighted = weights is not None
    engine = engine or engine_for(width, height, weighted)
    if engine not in engines(width, height, weighted):
        raise ValueError(f"the {engine} engine cannot take a {'weighted' if weighted else 'counted'} "
                         f"{width}x{height} grid")
    fn = _build.load("density").gm_density
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
                n, *view, width, height, _ENGINE_IDS[engine[0]], engine[1],
                acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
            name = "density_count" if weights is None else "density_weighted"
            kernels.check_status(rc, name)
            kernels.count_launch(name)
    return acc.to(torch.float32).reshape(height, width)


def density_grid(x, y, env, width: int, height: int, mask=None, weights=None,
                 lines: bool = False) -> torch.Tensor:
    """(height, width) float32 grid of the rows that are masked in (``mask``
    None: every row) and inside the viewport ``env``: their count, or the
    sum of their ``weights`` (float32, or int32 cast to float32 as the
    counterpart's ``astype(float32)`` does). A viewport without area
    raises, unless ``lines`` lets one of zero width or height count the
    rows on its line (:func:`viewport`). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(x, y, width, height, mask, weights)
    if kernels.on_cuda(x):
        return _launch(x, y, env, width, height, mask, weights, lines=lines)
    return density_plain(x, y, env, width, height, mask, weights, lines)
