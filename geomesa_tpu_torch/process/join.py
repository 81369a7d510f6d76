"""Spatial join / interlinking process.

Copy of ``geomesa_tpu/process/join.py`` (``spatial_join`` ``:31``; ref
role: the interlinking workload class -- topological joins between two
feature types, enrichment joins of a layer against reference windows).
Routes through
the join engine (``join/``): Z-range candidate planning, batched count ->
compact refinement on the left side's device, with the exact geometry
predicate of ``sql/functions.py`` refining the envelope pairs when the
right side carries real geometries (``SpatialFrame.spatial_join``).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.filter import ast


class _BatchView:
    """Minimal SpatialFrame-shaped view over an already-collected
    FeatureBatch (the right side of a cross-type join)."""

    def __init__(self, batch):
        self._batch = batch

    def collect(self):
        return self._batch


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
    """Join ``left_type``'s features against a right side.

    ``right`` is one of:

    - an ``(m, 4)`` float array of envelope windows: the ENVELOPE JOIN,
      returning the engine's :class:`~geomesa_tpu_torch.join.JoinResult`
      (exact inclusive point-in-window pairs for point schemas, envelope
      overlap for non-point ones; ``distance`` pads the windows). Without
      a ``device_index`` the left rows come from ``store.query`` with
      ``left_filter`` and the engine runs on the store's device (the card
      unless the store was made with ``device="cpu"``);
    - a ``FeatureBatch`` or another type name: the PREDICATE JOIN,
      returning ``(left_batch, right_batch, pairs)`` with the exact ``on``
      predicate (``intersects`` | ``contains`` | ``within`` | ``dwithin``
      with ``distance``), as ``SpatialFrame.spatial_join``.
      ``right_filter`` applies to a type name only.

    ``device_index`` serves the left side from its resident mirror (the
    engine's join layout caches per staged generation); without one the
    left side is collected per call, with the right side's extent pushed
    down into the store's scan. ``sched`` rides the refinement batches
    through the query scheduler. A ``mesh`` raises (ROADMAP item 7)."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.sql.frame import SpatialFrame

    lf = parse_ecql(left_filter) if isinstance(left_filter, str) else (left_filter or ast.Include)
    if isinstance(right, np.ndarray):
        from geomesa_tpu_torch.join import JoinEngine

        envs = np.asarray(right, np.float64).reshape(-1, 4)
        if distance:
            envs = envs + np.array([-distance, -distance, distance, distance])
        if device_index is not None:
            from geomesa_tpu_torch.join.engine import filter_gate

            eng = JoinEngine(device_index, sched=sched, mesh=mesh)
            gate = None if lf is ast.Include else filter_gate(device_index, lf)
            return eng.join(envs, gate=gate)
        from geomesa_tpu_torch.query.plan import Query

        batch = store.query(left_type, Query(filter=lf)).batch
        eng = JoinEngine(batch=batch, sft=store.get_schema(left_type), sched=sched, mesh=mesh,
                         device=getattr(store, "device", None))
        return eng.join(envs)

    frame = SpatialFrame(store, left_type)
    if lf is not ast.Include:
        frame = frame.where(lf)
    if isinstance(right, str):
        rframe = SpatialFrame(store, right)
        if right_filter is not None:
            rframe = rframe.where(right_filter)
    else:
        rframe = _BatchView(right)
    return frame.spatial_join(rframe, on=on, distance=distance, device_index=device_index,
                              sched=sched, mesh=mesh)
