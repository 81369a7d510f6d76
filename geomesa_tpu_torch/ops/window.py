"""The window-union mask (rows inside ANY of m runtime windows) and the
window-pair pack (which of 64 windows each row is inside, as bit words).

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

The pair pack (:func:`pairs_pack`, counterpart: the ``packed`` closure of
``DeviceIndex.window_pairs_query``, ``geomesa_tpu/device_cache.py:1870``)
keeps the window axis: windows come in groups of 64, and each row's hits
in a group are one 64-bit word (bit j: window j of the group). The words
are made over row blocks of ``(rows, windows)`` compares bounded as above
(the bools packed eight to a byte, eight bytes to a word), never a
``(n, 64)`` array over every row; rows with no hit drop out block by
block. Per group, the rows with a hit come first in row order and at most
``C`` are kept, beside the group's true count: a caller whose group
overflowed ``C`` takes the group's full word plane (:func:`group_words`).

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


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _words(xc, yc, e, groups: int) -> torch.Tensor:
    """(rows, groups) int64 hit words of rows ``xc``/``yc`` against the
    ``64 * groups`` windows ``e`` (a tensor, (W, 4)): bit j of word g is
    window ``64 g + j``. Little-endian bytes of eight bools each, viewed as
    int64, so no 64-bit shift or carry enters."""
    hit = (xc[:, None] >= e[:, 0]) & (xc[:, None] <= e[:, 2]) & (
        yc[:, None] >= e[:, 1]) & (yc[:, None] <= e[:, 3])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=xc.device)
    b = (hit.view(hit.shape[0], -1, 8).to(torch.uint8) * w).sum(-1, dtype=torch.uint8)
    return b.view(torch.int64).view(hit.shape[0], groups)


def _union_rows(x, y, env: np.ndarray, row_ok) -> torch.Tensor:
    """Row ids that may meet any window of ``env``: inside the windows'
    union envelope (NaN bounds skipped) and, with ``row_ok``, gated on."""
    lo = np.fmin.reduce(env[:, :2], axis=0)
    hi = np.fmax.reduce(env[:, 2:], axis=0)
    u = torch.from_numpy(np.concatenate([lo, hi]).astype(np.float32)).to(x.device)
    inside = (x >= u[0]) & (x <= u[2]) & (y >= u[1]) & (y <= u[3])
    if row_ok is not None:
        inside &= row_ok
    return torch.nonzero(inside).squeeze(1)


def pairs_pack(x: torch.Tensor, y: torch.Tensor, env: np.ndarray, row_ok, cap: int):
    """The pair pack of ``G = len(env) // 64`` window groups over the
    float32 planes ``x``/``y``: ``env`` is (64 G, 4) float32 (widened by
    the caller; padding windows inverted), ``row_ok`` an optional bool gate
    over the rows. Returns (rows, words, counts) on the planes' device:
    ``counts`` (G,) int64 is each group's number of rows with a hit;
    ``rows`` and ``words`` (int64) hold, group after group, the first
    ``min(count, cap)`` such rows in row order with their hit words."""
    groups = env.shape[0] // 64
    dev = x.device
    counts = torch.zeros(groups, dtype=torch.int64, device=dev)
    e = torch.from_numpy(np.ascontiguousarray(env, np.float32)).to(dev)
    real = ~((env[:, 0] > env[:, 2]) | (env[:, 1] > env[:, 3]))
    cand = _union_rows(x, y, env[real], row_ok) if real.any() else (
        torch.zeros(0, dtype=torch.int64, device=dev))
    rid, grp, word = [], [], []
    step = max(1, _BLOCK_ELEMS // env.shape[0])
    for s in range(0, cand.numel(), step):
        rows = cand[s: s + step]
        w = _words(x[rows], y[rows], e, groups)
        at = torch.nonzero(w)  # (row, group) of every nonzero word, row-major
        rid.append(rows[at[:, 0]])
        grp.append(at[:, 1])
        word.append(w[at[:, 0], at[:, 1]])
    if not rid:
        e0 = torch.zeros(0, dtype=torch.int64, device=dev)
        return e0, e0.clone(), counts
    rid, grp, word = torch.cat(rid), torch.cat(grp), torch.cat(word)
    counts += torch.bincount(grp, minlength=groups)
    order = torch.sort(grp, stable=True).indices  # group-major, rows ascending
    first = torch.cumsum(counts, 0) - counts
    keep = order[(torch.arange(order.numel(), device=dev) - first[grp[order]]) < cap]
    return rid[keep], word[keep], counts


def group_words(x: torch.Tensor, y: torch.Tensor, env64: np.ndarray, row_ok) -> torch.Tensor:
    """The full word plane of one group of 64 windows: (n,) int64, zero for
    a row with no hit (or gated off), over row blocks."""
    n = x.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=x.device)
    e = torch.from_numpy(np.ascontiguousarray(env64, np.float32)).to(x.device)
    step = max(1, _BLOCK_ELEMS // 64)
    for s in range(0, n, step):
        out[s: s + step] = _words(x[s: s + step], y[s: s + step], e, 1)[:, 0]
    if row_ok is not None:
        out[~row_ok] = 0
    return out
