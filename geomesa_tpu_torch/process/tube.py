"""Tube select: spatio-temporal corridor search around a track.

Counterpart of ``geomesa_tpu/process/tube.py`` (ref: geomesa-process
TubeSelectProcess): given a track (ordered points with times), find
features within ``buffer_deg`` of the track's path AND within
``max_dt_ms`` of the track's interpolated time at the closest approach --
"who travelled with this vessel".

The coarse pass is one ``DeviceIndex.window_union_query`` with one
bbox+time window per segment. Without a resident index (or when it
cannot answer) the store answers one ``internal_query`` per segment and
the batches concatenate, deduped by fid, as in the counterpart. The fine
pass is the counterpart's host numpy over the candidates.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.process.knn import parse_base
from geomesa_tpu_torch.query.plan import internal_query


def _segment_windows(track_xy, track_t, buffer_deg, max_dt_ms):
    """(envs (m, 4), times (m, 2)) of the m segments of a track."""
    a, b = track_xy[:-1], track_xy[1:]
    envs = np.stack(
        [
            np.minimum(a[:, 0], b[:, 0]) - buffer_deg,
            np.minimum(a[:, 1], b[:, 1]) - buffer_deg,
            np.maximum(a[:, 0], b[:, 0]) + buffer_deg,
            np.maximum(a[:, 1], b[:, 1]) + buffer_deg,
        ],
        axis=1,
    )
    ta, tb = track_t[:-1], track_t[1:]
    times = np.stack(
        [np.minimum(ta, tb) - max_dt_ms, np.maximum(ta, tb) + max_dt_ms], axis=1
    )
    return envs, times


def tube_select(
    store,
    type_name: str,
    track_xy: np.ndarray,  # (m, 2) ordered track points
    track_t_ms: np.ndarray,  # (m,)
    buffer_deg: float,
    max_dt_ms: int,
    base_filter: "ast.Filter | str | None" = None,
    device_index=None,
    auths=None,
):
    """Returns the matching FeatureBatch."""
    base = parse_base(base_filter)
    sft = store.get_schema(type_name)
    geom, dtg = sft.geom_field, sft.dtg_field
    track_xy = np.asarray(track_xy, dtype=np.float64).reshape(-1, 2)
    track_t = np.asarray(track_t_ms, dtype=np.int64)
    envs, times = _segment_windows(track_xy, track_t, buffer_deg, max_dt_ms)

    merged = None
    if device_index is not None and len(track_xy) > 1:
        merged = device_index.window_union_query(
            envs, times, auths=auths,
            base=None if base is ast.Include else base,
        )
    if merged is None:
        # coarse pass: one bbox+time query per track segment, unioned
        chunks = []
        for e, t in zip(envs, times):
            f = ast.And((ast.BBox(geom, *(float(v) for v in e)),
                         ast.During(dtg, int(t[0]), int(t[1])), base))
            b = store.query(type_name, internal_query(f, auths=auths)).batch
            if len(b):
                chunks.append(b)
        if not chunks:
            return store.query(type_name, internal_query(ast.Exclude, auths=auths)).batch
        merged = chunks[0] if len(chunks) == 1 else FeatureBatch.concat(chunks)
        # dedupe by fid, first occurrence kept in order
        _, first = np.unique(merged.fids, return_index=True)
        merged = merged.take(np.sort(first))
    if len(merged) == 0:
        return merged

    # fine pass: exact distance to the nearest segment + time consistency
    x, y = merged.point_coords(geom)
    t = merged.column(dtg)
    ok = np.zeros(len(merged), dtype=bool)
    best = np.full(len(merged), np.inf)
    for i in range(len(track_xy) - 1):
        d, frac = _point_segment_dist(x, y, *track_xy[i], *track_xy[i + 1])
        seg_t = track_t[i] + frac * (track_t[i + 1] - track_t[i])
        cand = (d <= buffer_deg) & (np.abs(t - seg_t) <= max_dt_ms) & (d < best)
        ok |= cand
        best = np.where(cand, d, best)
    return merged.take(np.nonzero(ok)[0])


def _point_segment_dist(px, py, x0, y0, x1, y1):
    """Distance from points to a segment + projection fraction [0, 1]."""
    dx, dy = x1 - x0, y1 - y0
    L2 = dx * dx + dy * dy
    if L2 == 0:
        d = np.sqrt((px - x0) ** 2 + (py - y0) ** 2)
        return d, np.zeros_like(px)
    frac = np.clip(((px - x0) * dx + (py - y0) * dy) / L2, 0.0, 1.0)
    cx, cy = x0 + frac * dx, y0 + frac * dy
    return np.sqrt((px - cx) ** 2 + (py - cy) ** 2), frac
