"""The window-union mask: rows inside ANY of m runtime windows.

Counterpart of the ``umask`` closure inside
``DeviceIndex.window_union_query`` in ``geomesa_tpu/device_cache.py``
(the corridor and buffer coarse pass of tube select and proximity
search). The reference broadcasts every row against every window in one
XLA dispatch, an (n, m) array; at 2^26 rows and 256 windows that is 16
GiB of bools. Here, as torch ops that run alike on CPU and CUDA tensors:

1. the union envelope of the windows prunes the rows (one pass over the
   planes, a superset of the answer: any row in a window lies in it);
2. the surviving rows meet the windows in blocks of ``(rows, m)``
   compares, each temporary at most ``_BLOCK_ELEMS`` elements.

Bounds widen one float32 ulp outward on the host, as the reference's do
(float32 residency can only over-include: candidate semantics). Time
windows are inclusive int64 ``[t_lo, t_hi]`` tested on the hi/lo lanes
of the date plane. A window with ``xmin > xmax`` or ``ymin > ymax`` after
the widening, or with a NaN bound, matches nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.ops.int64lanes import cmp_lanes

_BLOCK_ELEMS = 1 << 26  # (rows, m) elements per block: 64 MB of bools


def widen(envs) -> np.ndarray:
    """(m, 4) float32 ``[xmin, ymin, xmax, ymax]``: the float64 bounds
    rounded to float32, then one ulp outward."""
    e = np.asarray(envs, np.float64).reshape(-1, 4).astype(np.float32)
    out = np.empty_like(e)
    out[:, :2] = np.nextafter(e[:, :2], np.float32(-np.inf))
    out[:, 2:] = np.nextafter(e[:, 2:], np.float32(np.inf))
    return out


def union_mask(
    x: torch.Tensor,
    y: torch.Tensor,
    env: np.ndarray,
    thi: "torch.Tensor | None" = None,
    tlo: "torch.Tensor | None" = None,
    times: "np.ndarray | None" = None,
) -> torch.Tensor:
    """Bool mask over the rows of the float32 planes ``x``/``y``: inside any
    window of ``env`` (from :func:`widen`) and, with ``times`` (m, 2), at a
    date (``thi``/``tlo`` lanes) inside that same window's time range."""
    n, m = x.shape[0], env.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=x.device)
    if n == 0 or m == 0:
        return out
    # union envelope; fmin/fmax skip NaN bounds (such windows match nothing)
    lo = np.fmin.reduce(env[:, :2], axis=0)
    hi = np.fmax.reduce(env[:, 2:], axis=0)
    u = torch.from_numpy(np.concatenate([lo, hi]).astype(np.float32)).to(x.device)
    cand = torch.nonzero((x >= u[0]) & (x <= u[2]) & (y >= u[1]) & (y <= u[3])).squeeze(1)
    if cand.numel() == 0:
        return out
    e = torch.from_numpy(env).to(x.device)
    if times is not None:
        # int64 bounds as (signed hi, unsigned lo) words, both held in int64
        t = np.asarray(times, np.int64).reshape(-1, 2)
        bh, bl = (torch.from_numpy(a).to(x.device) for a in (t >> 32, t & 0xFFFFFFFF))
    step = max(1, _BLOCK_ELEMS // m)
    for s in range(0, cand.numel(), step):
        rows = cand[s: s + step]
        xc, yc = x[rows][:, None], y[rows][:, None]
        hit = (xc >= e[:, 0]) & (xc <= e[:, 2]) & (yc >= e[:, 1]) & (yc <= e[:, 3])
        if times is not None:
            # through int32 views: CUDA cannot gather uint32
            vh, vl = thi[rows][:, None], tlo.view(torch.int32)[rows][:, None]
            hit &= cmp_lanes(">=", vh, vl, bh[:, 0], bl[:, 0])
            hit &= cmp_lanes("<=", vh, vl, bh[:, 1], bl[:, 1])
        out[rows] = hit.any(dim=1)
    return out
