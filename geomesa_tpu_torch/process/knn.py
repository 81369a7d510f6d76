"""k-nearest-neighbours by iterative expanding-window search.

Counterpart of ``geomesa_tpu/process/knn.py`` (ref: geomesa-process
KNearestNeighborSearchProcess and KNNQuery's expanding-window algorithm):
query a small bbox around the target; if fewer than k hits, grow the
window and retry; finish with a confidence pass at the k-th distance
radius so no closer neighbour outside the last window is missed. With a
resident ``device_index`` whose planes and filter are on the device, one
``DeviceIndex.knn`` call answers and no window is probed.

Without a resident answer the windows go to the store as
``internal_query(f, auths=auths)``, as in the counterpart (a
``MemoryDataStore`` answers them; a ``BatchStore`` serves no filtered
query and raises).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.query.plan import internal_query


def _dist_deg(x, y, px, py):
    """Equirectangular-approx distance in degrees (lat-corrected lon)."""
    dx = (x - px) * np.cos(np.radians(py))
    dy = y - py
    return np.sqrt(dx * dx + dy * dy)


def _k_nearest(batch, geom: str, px: float, py: float, k: int):
    """(top-k batch, distances) of one candidate batch, nearest first."""
    if len(batch) == 0:
        return batch, np.array([])
    x, y = batch.point_coords(geom)
    d = _dist_deg(x, y, px, py)
    order = np.argsort(d, kind="stable")[:k]
    return batch.take(order), d[order]


def parse_base(base_filter) -> ast.Filter:
    """A process's base filter: an ECQL string, a filter AST, or None
    (INCLUDE)."""
    if isinstance(base_filter, str):
        from geomesa_tpu_torch.filter.ecql import parse_ecql

        return parse_ecql(base_filter)
    return base_filter or ast.Include


def knn(
    store,
    type_name: str,
    px: float,
    py: float,
    k: int,
    base_filter: "ast.Filter | str | None" = None,
    initial_radius_deg: float = 0.05,
    max_radius_deg: float = 45.0,
    device_index=None,
    auths=None,
):
    """Returns (batch_of_k_nearest, distances_deg), nearest first.

    If fewer than k features exist inside the ``max_radius_deg`` box
    around the target, only those are returned: the search never widens
    past that box. ``auths`` applies row security on every path (absent:
    none, fail closed)."""
    base = parse_base(base_filter)
    geom = store.get_schema(type_name).geom_field

    if device_index is not None:
        got = device_index.knn(
            px, py, k,
            query=None if base is ast.Include else base,
            auths=auths,
            max_radius_deg=max_radius_deg,
        )
        if got is not None:
            return got

    def window(rx: float, ry: float):
        if device_index is not None and base is ast.Include:
            got = device_index.bbox_window_query(
                px - rx, py - ry, px + rx, py + ry, auths=auths
            )
            if got is not None:
                return got
        f = ast.And((ast.BBox(geom, px - rx, py - ry, px + rx, py + ry), base))
        if device_index is not None:
            return device_index.query(f, auths=auths)
        return store.query(type_name, internal_query(f, auths=auths)).batch

    r = initial_radius_deg
    batch = None
    last_r = None  # radius of the last window actually scanned
    while r <= max_radius_deg:
        res = window(r, r)
        last_r = r
        if len(res) >= k:
            batch = res
            break
        r *= 2
    if batch is None:
        # fewer than k features in the max-radius box: one pass at exactly
        # that radius (unless the loop scanned it) and done
        if last_r != max_radius_deg:
            res = window(max_radius_deg, max_radius_deg)
        return _k_nearest(res, geom, px, py, k)
    _, d = _k_nearest(batch, geom, px, py, k)
    kth = float(d[-1]) if len(d) else 0.0
    # confidence pass: a point within the k-th distance lies inside the
    # raw-degree box of half-extents (kth / cos(lat), kth), capped at the
    # search radius (near the poles rx could otherwise reach 100x kth)
    rx = min(kth / max(np.cos(np.radians(py)), 0.01), max_radius_deg)
    return _k_nearest(window(rx, min(kth, max_radius_deg)), geom, px, py, k)
