"""Spatial join / interlinking process.

Copy of ``geomesa_tpu/process/join.py`` (lines 31-109) with the resident
half of ``SpatialFrame.spatial_join`` (``geomesa_tpu/sql/frame.py:261``
``_engine_join`` and ``:389`` ``_exact_residual``) and the four predicates
it refines with (``st_intersects``, ``st_contains``, ``st_within``,
``st_dwithin`` of ``geomesa_tpu/sql/functions.py``) over the port's
``geom/predicates.py``. Routes through the join engine (``join/``):
Z-range candidate planning, batched count -> compact refinement on the
index's device, then the exact predicate over each window's candidates.

Not in the port yet: the store path (no ``device_index``, or another type
name as the right side), which needs ``SpatialFrame`` over the store's
filtered scan (ROADMAP item 5).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom.base import Geometry, MultiPolygon, Point, Polygon
from geomesa_tpu_torch.geom.predicates import (
    distance_segments,
    geometry_intersects,
    geometry_within,
    points_in_polygon,
    pt_seg_dist2,
)

_STORE_PATH = (
    "spatial_join without a device_index, or with a type name on the right, "
    "needs SpatialFrame over the store's filtered scan: not in the port yet: "
    "ROADMAP, port queue item 5, sql/frame.py and the store path of spatial_join"
)


def spatial_join(
    store,
    left_type: str,
    right,
    on: str = "intersects",
    distance: "float | None" = None,
    left_filter: "ast.Filter | str | None" = None,
    right_filter: "ast.Filter | str | None" = None,
    device_index=None,
    sched=None,
    mesh=None,
):
    """Join ``left_type``'s features, served by the resident
    ``device_index``, against a right side.

    ``right`` is one of:

    - an ``(m, 4)`` float array of envelope windows: the ENVELOPE JOIN,
      returning the engine's :class:`~geomesa_tpu_torch.join.JoinResult`
      (exact inclusive point-in-window pairs for point schemas, envelope
      overlap for non-point ones; ``distance`` pads the windows);
    - a ``FeatureBatch``: the PREDICATE JOIN, returning ``(left_batch,
      right_batch, pairs)`` with the exact ``on`` predicate
      (``intersects`` | ``contains`` | ``within`` | ``dwithin`` with
      ``distance``) refining the engine's candidates; ``left_batch`` holds
      the left rows the pairs reference and ``pairs`` is (k, 2) [left,
      right] indices, sorted by right row then left row.

    ``left_filter`` gates the left rows (any filter shape: the index's mask,
    with its validity plane and the fail-closed visibility verdict);
    ``right_filter`` applies to a type name only, as in the counterpart;
    ``sched`` rides the refinement batches through the query scheduler. A
    ``mesh`` raises (ROADMAP item 7), and so do the store-path shapes
    (item 5)."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.join import JoinEngine
    from geomesa_tpu_torch.join.engine import filter_gate

    lf = parse_ecql(left_filter) if isinstance(left_filter, str) else (left_filter or ast.Include)
    if isinstance(right, np.ndarray):
        envs = np.asarray(right, np.float64).reshape(-1, 4)
        if distance:
            envs = envs + np.array([-distance, -distance, distance, distance])
        if device_index is None:
            raise NotImplementedError(_STORE_PATH)
        eng = JoinEngine(device_index, sched=sched, mesh=mesh)
        gate = None if lf is ast.Include else filter_gate(device_index, lf)
        return eng.join(envs, gate=gate)
    if isinstance(right, str) or device_index is None:
        raise NotImplementedError(_STORE_PATH)
    preds = {"intersects": st_intersects, "contains": st_contains, "within": st_within}
    if on == "dwithin" and distance is None:
        raise ValueError("dwithin join needs distance=")
    if on not in preds and on != "dwithin":
        raise ValueError(f"unknown join predicate {on!r}")
    if not len(right) or device_index.sft.geom_field is None:
        raise NotImplementedError(_STORE_PATH)  # the counterpart's store-side path
    return _engine_join(device_index, right, lf, on, distance, preds, sched, mesh)


def _engine_join(di, right, lf, on, distance, preds, sched, mesh):
    """The join engine's coarse pass (planned, batched) + per-window exact
    refinement (``SpatialFrame._engine_join``)."""
    from geomesa_tpu_torch.join import JoinEngine
    from geomesa_tpu_torch.join.engine import filter_gate

    geom_r = right.sft.geom_field
    rcol = right.columns[geom_r]
    eng = JoinEngine(di, sched=sched, mesh=mesh)
    pad = distance or 0.0
    envs = right.bboxes(geom_r).astype(np.float64)
    if pad:
        envs = envs + np.array([-pad, -pad, pad, pad])
    gate = None if lf is ast.Include else filter_gate(di, lf)
    res = eng.join(envs, gate=gate)
    left = di._host_rows()
    lcol = left.columns[left.sft.geom_field]
    rows, wins = _exact_residual(lcol, rcol, res.rows, res.wins, len(right), on, distance, preds)
    pairs = np.stack([rows, wins], axis=1) if len(rows) else np.empty((0, 2), np.int64)
    # the left batch holds exactly the rows the pairs reference
    if len(pairs):
        uniq, inv = np.unique(pairs[:, 0], return_inverse=True)
        left = left.take(uniq)
        pairs = np.stack([inv.reshape(-1).astype(np.int64), pairs[:, 1]], axis=1)
    else:
        left = left.take(np.empty(0, np.int64))
    return left, right, pairs


def _exact_residual(lcol, rcol, rows, wins, m, on, distance, preds):
    """Exact-predicate refinement of the engine's envelope pairs, window by
    window (pairs arrive window-sorted): the vectorized predicate over each
    window's few candidates."""
    if len(rows) == 0:
        return rows, wins
    starts = np.searchsorted(wins, np.arange(m))
    ends = np.searchsorted(wins, np.arange(m), side="right")
    keep = np.zeros(len(rows), bool)
    for j in range(m):
        s, e = starts[j], ends[j]
        if s == e:
            continue
        cand = rows[s:e]
        g = _row_geom(rcol, j)
        sub = lcol[cand] if lcol.dtype == object else lcol[cand, :]
        if on == "dwithin":
            hit = st_dwithin(sub, g, distance)
        else:
            hit = preds[on](sub, g)
        keep[s:e] = np.asarray(hit)
    return rows[keep], wins[keep]


# -- the predicates (copies of geomesa_tpu/sql/functions.py) -----------------


def _is_point_col(col) -> bool:
    return isinstance(col, np.ndarray) and col.dtype != object and col.ndim == 2


def _row_geom(col, i):
    if _is_point_col(col):
        return Point(float(col[i, 0]), float(col[i, 1]))
    return col[i]


def _pairwise(a, b, fn, point_fast=None):
    """A relation over (column, scalar), (scalar, column), (column,
    column) or (scalar, scalar) inputs."""
    a_scalar = isinstance(a, Geometry)
    b_scalar = isinstance(b, Geometry)
    if a_scalar and b_scalar:
        return fn(a, b)
    if _is_point_col(a) and b_scalar and point_fast is not None:
        return point_fast(a, b, False)
    if a_scalar and _is_point_col(b) and point_fast is not None:
        return point_fast(b, a, True)
    n = len(a) if not a_scalar else len(b)
    out = np.empty(n, dtype=bool)
    for i in range(n):
        ga = a if a_scalar else _row_geom(a, i)
        gb = b if b_scalar else _row_geom(b, i)
        out[i] = fn(ga, gb)
    return out


def _points_vs_geom_intersects(pts: np.ndarray, g, flipped: bool):
    # a symmetric relation: ``flipped`` does not matter
    if isinstance(g, (Polygon, MultiPolygon)):
        x, y = pts[:, 0], pts[:, 1]
        if isinstance(g, Polygon):
            return points_in_polygon(x, y, g.rings())
        m = np.zeros(len(pts), dtype=bool)
        for p in g.polygons:
            m |= points_in_polygon(x, y, p.rings())
        return m
    out = np.empty(len(pts), dtype=bool)
    for i in range(len(pts)):
        out[i] = geometry_intersects(Point(float(pts[i, 0]), float(pts[i, 1])), g)
    return out


def st_intersects(a, b):
    return _pairwise(a, b, geometry_intersects, point_fast=_points_vs_geom_intersects)


def st_contains(a, b):
    """a contains b (b within a)."""

    def fn(ga, gb):
        return geometry_within(gb, ga)

    def pf(pts, g, flipped):
        if flipped:
            # points containing g: a point contains only an equal point
            if isinstance(g, Point):
                return (pts[:, 0] == g.x) & (pts[:, 1] == g.y)
            return np.zeros(len(pts), dtype=bool)
        if isinstance(g, (Polygon, MultiPolygon)):
            return _points_vs_geom_intersects(pts, g, False)
        return np.array([fn(_row_geom(pts, i), g) for i in range(len(pts))])

    if isinstance(a, Geometry) and not isinstance(b, Geometry):
        if _is_point_col(b):
            return pf(b, a, False)
        return np.array([fn(a, gb) for gb in b], dtype=bool)
    if isinstance(b, Geometry) and not isinstance(a, Geometry):
        if _is_point_col(a):
            return pf(a, b, True)
        return np.array([fn(ga, b) for ga in a], dtype=bool)
    return _pairwise(a, b, fn)


def st_within(a, b):
    """a within b."""
    return st_contains(b, a)


def st_distance(a, b):
    """Exact planar distance: 0 when intersecting, else the least
    point-to-segment distance both ways."""

    def fn(ga, gb):
        if isinstance(ga, Point) and isinstance(gb, Point):
            return float(np.hypot(ga.x - gb.x, ga.y - gb.y))
        if geometry_intersects(ga, gb):
            return 0.0
        # the endpoints of every segment, so hole-ring vertices take part
        sa, sb = distance_segments(ga), distance_segments(gb)
        pa = np.concatenate([sa[:, 0:2], sa[:, 2:4]], axis=0)
        pb = np.concatenate([sb[:, 0:2], sb[:, 2:4]], axis=0)
        return min(float(np.sqrt(pt_seg_dist2(pa, sb).min())),
                   float(np.sqrt(pt_seg_dist2(pb, sa).min())))

    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return fn(a, b)
    if _is_point_col(a) and isinstance(b, Point):
        return np.hypot(a[:, 0] - b.x, a[:, 1] - b.y)
    if _is_point_col(b) and isinstance(a, Point):
        return np.hypot(b[:, 0] - a.x, b[:, 1] - a.y)
    if _is_point_col(a) and _is_point_col(b):
        return np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    n = len(a) if not isinstance(a, Geometry) else len(b)
    return np.array([
        fn(a if isinstance(a, Geometry) else _row_geom(a, i),
           b if isinstance(b, Geometry) else _row_geom(b, i))
        for i in range(n)
    ])


def st_dwithin(a, b, distance: float):
    return st_distance(a, b) <= distance
