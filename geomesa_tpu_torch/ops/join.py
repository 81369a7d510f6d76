"""Batched spatial-join refinement: candidate runs -> (row, window) pairs.

Copy of ``geomesa_tpu/ops/join.py`` (lines 63-228). The join engine
(``join/``) plans candidate RUNS -- contiguous row ranges of the Z-sorted
join layout, one per (window, covering cell) -- and this module turns run
batches into emitted pairs:

- **expansion**: run p contributes rows ``starts[p] .. starts[p] + lens[p]``
  against window ``wins[p]``; the flat candidate space is segmented by
  the run-length cumsum (one ``searchsorted``, no per-run dispatch);
- **refinement**: each candidate's coordinates test against its window's
  envelope in float64 (inclusive; envelope overlap for non-point rows),
  except candidates of INTERIOR runs, hits by construction;
- **emission**: count, then compact -- a count pass says whether anything
  survives (and how much), then one compaction keeps the surviving pairs
  in candidate order, which is (window, row) order as planned.

The host twins (``expand_runs``, ``refine_host``, ``refine_host_env``)
are numpy, the oracle the torch passes are held against and the engine
of an index on the CPU. :func:`count_pairs` and :func:`compact_pairs` are
torch ops that run alike on CPU and CUDA tensors (the counterpart's are
XLA programs, no Pallas kernel); PyTorch runs eagerly, so the
counterpart's jit caches and power-of-two shape buckets have no place
here. The mesh launches (``mesh_count_kernel``, ``mesh_join_kernel``) wait
for the mesh (ROADMAP item 7).
"""

from __future__ import annotations

import numpy as np
import torch

# -- host expansion + refinement (the oracle engine) -----------------------


def expand_runs(starts, lens, wins, interior):
    """Flatten candidate runs into aligned (rows, wins, interior) arrays:
    ``rows`` enumerates ``starts[p] .. starts[p] + lens[p]`` for each run p
    in order. Zero-length runs are dropped first."""
    lens = np.asarray(lens, np.int64)
    keep = lens > 0
    if not np.all(keep):
        starts = np.asarray(starts)[keep]
        wins = np.asarray(wins)[keep]
        interior = np.asarray(interior)[keep]
        lens = lens[keep]
    if len(lens) == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, bool)
    total = int(lens.sum())
    csum = np.cumsum(lens)
    # rows via a delta-encoded cumsum: position 0 starts the first run,
    # every run boundary jumps from the previous run's end to the next
    # run's start, everything else steps by one
    deltas = np.ones(total, np.int64)
    deltas[0] = int(starts[0])
    deltas[csum[:-1]] = np.asarray(starts[1:], np.int64) - (
        np.asarray(starts[:-1], np.int64) + lens[:-1] - 1
    )
    rows = np.cumsum(deltas)
    winv = np.repeat(np.asarray(wins, np.int64), lens)
    iflag = np.repeat(np.asarray(interior, bool), lens)
    return rows, winv, iflag


def refine_host(xs, ys, envs, rows, winv, iflag, gate=None):
    """Exact inclusive point-in-window refinement of expanded candidates:
    the hit mask over them. Interior candidates skip the coordinate fetch;
    ``gate`` (a bool plane over the rows) is ANDed into every candidate."""
    hit = iflag.copy()
    bidx = np.nonzero(~iflag)[0]
    if len(bidx):
        brow = rows[bidx]
        e = envs[winv[bidx]]
        px = xs[brow]
        py = ys[brow]
        hit[bidx] = (px >= e[:, 0]) & (px <= e[:, 2]) & (py >= e[:, 1]) & (py <= e[:, 3])
    if gate is not None:
        hit &= gate[rows]
    return hit


def refine_host_env(ex0, ey0, ex1, ey1, envs, rows, winv, iflag, gate=None):
    """Envelope-OVERLAP refinement for non-point rows (per-row envelope
    planes against the windows): the coarse pass of a topological join."""
    hit = iflag.copy()
    bidx = np.nonzero(~iflag)[0]
    if len(bidx):
        brow = rows[bidx]
        e = envs[winv[bidx]]
        hit[bidx] = (
            (ex1[brow] >= e[:, 0])
            & (ex0[brow] <= e[:, 2])
            & (ey1[brow] >= e[:, 1])
            & (ey0[brow] <= e[:, 3])
        )
    if gate is not None:
        hit &= gate[rows]
    return hit


# -- torch passes (count, then compact) ------------------------------------


def _expand_refine(planes, starts, lens, csum, winv, iflag, envs, total, gate):
    """The shared body: expand one run batch into its ``total`` candidates
    and test each. ``planes`` is (x, y) for point layouts or (x0, y0, x1,
    y1) envelope planes (the overlap test), float64; ``starts``, ``lens``,
    ``csum`` (inclusive run-length cumsum) and ``winv`` are int64 tensors,
    ``iflag`` bool, ``envs`` (m, 4) float64, ``gate`` an optional bool plane
    over the rows. Returns (row, win, hit) over the candidates."""
    p = torch.arange(total, dtype=torch.int64, device=csum.device)
    seg = torch.searchsorted(csum, p, right=True)
    row = starts[seg] + (p - (csum[seg] - lens[seg]))
    win = winv[seg]
    e = envs[win]
    if len(planes) == 2:
        px, py = planes[0][row], planes[1][row]
        env_hit = (px >= e[:, 0]) & (px <= e[:, 2]) & (py >= e[:, 1]) & (py <= e[:, 3])
    else:
        env_hit = (
            (planes[2][row] >= e[:, 0]) & (planes[0][row] <= e[:, 2])
            & (planes[3][row] >= e[:, 1]) & (planes[1][row] <= e[:, 3])
        )
    hit = iflag[seg] | env_hit
    if gate is not None:
        hit &= gate[row]
    return row, win, hit


def count_pairs(planes, starts, lens, csum, winv, iflag, envs, total, gate=None) -> int:
    """The count pass: how many of the batch's candidates survive."""
    _, _, hit = _expand_refine(planes, starts, lens, csum, winv, iflag, envs, total, gate)
    return int(hit.sum())


def compact_pairs(planes, starts, lens, csum, winv, iflag, envs, total, gate=None):
    """The compact pass: the surviving (row, window) pairs in candidate
    order, as int64 tensors on the planes' device."""
    row, win, hit = _expand_refine(planes, starts, lens, csum, winv, iflag, envs, total, gate)
    keep = torch.nonzero(hit).squeeze(1)
    return row[keep], win[keep]
