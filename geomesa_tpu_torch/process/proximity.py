"""Proximity search: features within a distance of a set of input
geometries.

Counterpart of ``geomesa_tpu/process/proximity.py`` (ref: geomesa-process
ProximitySearchProcess): each input's envelope, expanded by the distance,
is one window of a ``DeviceIndex.window_union_query`` (or of one OR of
bboxes asked of the store as an ``internal_query``, as in the
counterpart); then an exact vectorised point-to-segment distance pass over
the candidates.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Geometry, Point
from geomesa_tpu_torch.geom.predicates import distance_segments, pt_seg_project
from geomesa_tpu_torch.process.knn import parse_base
from geomesa_tpu_torch.query.plan import internal_query


def _as_geoms(inputs) -> list:
    if isinstance(inputs, Geometry):
        return [inputs]
    out = []
    for g in inputs:
        if isinstance(g, Geometry):
            out.append(g)
        else:  # (x, y) pair
            out.append(Point(float(g[0]), float(g[1])))
    return out


def proximity_search(
    store,
    type_name: str,
    inputs,
    distance_deg: float,
    base_filter: "ast.Filter | str | None" = None,
    device_index=None,
    auths=None,
):
    """Returns (batch, dist_deg): data features within ``distance_deg`` of
    any input geometry, with the distance to the nearest input."""
    geoms = _as_geoms(inputs)
    if not geoms:
        raise ValueError("no input geometries")
    base = parse_base(base_filter)
    geom_field = store.get_schema(type_name).geom_field
    envs = np.array(
        [
            [
                g.envelope.xmin - distance_deg,
                g.envelope.ymin - distance_deg,
                g.envelope.xmax + distance_deg,
                g.envelope.ymax + distance_deg,
            ]
            for g in geoms
        ]
    )
    batch = None
    if device_index is not None:
        batch = device_index.window_union_query(
            envs, auths=auths, base=None if base is ast.Include else base,
        )
    if batch is None:
        # one expanded bbox PER input (not one union envelope: two
        # far-apart inputs would otherwise pull in everything between them)
        boxes = tuple(ast.BBox(geom_field, *e) for e in envs)
        f = ast.And((boxes[0] if len(boxes) == 1 else ast.Or(boxes), base))
        batch = store.query(type_name, internal_query(f, auths=auths)).batch
    if len(batch) == 0:
        return batch, np.array([])
    x, y = batch.point_coords(geom_field)
    segs = np.concatenate([distance_segments(g) for g in geoms], axis=0)
    # min distance from each candidate point to any input segment
    dist = np.sqrt(pt_seg_project(np.stack([x, y], axis=1), segs)[1].min(axis=1))
    keep = np.nonzero(dist <= distance_deg)[0]
    return batch.take(keep), dist[keep]
