"""Density (heatmap) rasterization.

Counterpart of ``geomesa_tpu/process/density.py`` (ref: geomesa-process
DensityProcess and the DensityIterator): features in the query window are
accumulated onto a width x height grid, optionally weighted by an
attribute. With a resident ``device_index`` the filter mask and the
binning run next to the data (``DeviceIndex.density``); otherwise the
store query materializes the matched batch and the grid accumulates from
its coordinates -- on the card through the same density kernel with no
mask, or on the host in numpy.

Stores with chunk pre-aggregates (the file-system store's partition
format v2) answer unweighted bbox+time densities without auths from the
manifest's coarse per-chunk histograms (``store.density_pushdown``:
interior chunks prorated, boundary chunks refined through the filter
scan; total mass exact, placement within coarse-cell tolerance);
``hints={"agg.pushdown": False}`` forces the row-scan path.

``query`` is a ``Query`` (whose ``auths`` hint wins), an ECQL string or
a filter AST.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.device import resolve_device
from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.ops.density import density_grid, inverted, viewport
from geomesa_tpu_torch.query.plan import Query


def _split_query(query, auths):
    """(filter, auths) from a query that may be a full Query (whose auths
    hint takes precedence) or a bare CQL string / filter AST."""
    if isinstance(query, Query):
        return (
            query.filter if query.filter is not None else ast.Include,
            query.hints.get("auths", auths),
        )
    return query, auths


def density(
    store,
    type_name: str,
    query,
    envelope,
    width: int,
    height: int,
    weight_attr: "str | None" = None,
    use_device: bool = True,
    device_index=None,
    loose: "bool | None" = None,
    auths=None,
    device=None,
) -> np.ndarray:
    """(height, width) float32 grid of (weighted) feature counts.

    ``loose`` applies only to the resident path (key-plane cell
    granularity, the contract of ``DeviceIndex.count``/``query``);
    ``auths`` applies row security on both paths. The store path runs on
    ``device`` (``cuda:0`` unless the caller passes ``"cpu"``) when
    ``use_device``.

    Viewports without area answer as the resident path does on every
    path: an inverted viewport gives a zero grid, and one of zero width or
    height counts the rows on its line in cell 0 of that axis
    (``ops/density.py`` ``viewport(..., lines=True)``). The counterpart's
    store path raises ``ZeroDivisionError`` there instead (ROADMAP section
    3, reference faults the port does not copy)."""
    filt, auths = _split_query(query, auths)
    if isinstance(filt, str):
        from geomesa_tpu_torch.filter.ecql import parse_ecql

        filt = parse_ecql(filt)
    if device_index is not None:
        grid = device_index.density(
            filt, envelope, width, height, weight_attr=weight_attr,
            loose=loose, auths=auths,
        )
        if grid is not None:
            return grid
        # filter or planes not resident: fall through to the store path
    pushed = getattr(store, "density_pushdown", None)
    if pushed is not None and weight_attr is None and not auths:
        pd_query = query if isinstance(query, Query) else Query(filter=filt)
        grid = pushed(type_name, pd_query, envelope, width, height)
        if grid is not None:
            return grid
        # chunk stats cannot decide this query: the exact row-scan path
    # a caller's full Query keeps all its attributes and hints on the store
    # path, with the resolved auths merged in
    if isinstance(query, Query):
        import dataclasses

        hints = dict(query.hints)
        hints["auths"] = auths
        store_q = dataclasses.replace(query, filter=filt, hints=hints)
    else:
        store_q = Query(filter=filt, hints={"auths": auths})
    batch = store.query(type_name, store_q).batch
    if len(batch) == 0:
        return np.zeros((height, width), dtype=np.float32)
    x, y = batch.point_coords()
    w = (
        batch.column(weight_attr).astype(np.float64)
        if weight_attr
        else np.ones(len(batch))
    )
    if inverted(envelope):
        return np.zeros((height, width), dtype=np.float32)  # no row inside
    if use_device:
        return _density_device(x, y, w if weight_attr else None, envelope,
                               width, height, resolve_device(device))
    return _density_host(x, y, w, envelope, width, height)


def _density_host(x, y, w, env, width, height) -> np.ndarray:
    """numpy twin of ``_pixel_ids`` + scatter-add, in float64. An axis of
    zero extent places the rows on its line in cell 0, as the resident
    path does; an inverted viewport holds no row."""
    if inverted(env):
        return np.zeros((height, width), dtype=np.float32)
    xmin, ymin, xmax, ymax, sx, sy = viewport(env, width, height, lines=True)
    px = np.clip(np.floor((x - xmin) * sx), 0, width - 1).astype(np.int32)
    py = np.clip(np.floor((y - ymin) * sy), 0, height - 1).astype(np.int32)
    inside = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    grid = np.zeros(height * width, dtype=np.float64)
    np.add.at(grid, (py * width + px)[inside], w[inside])
    return grid.reshape(height, width).astype(np.float32)


def _density_device(x, y, w, env, width, height, device) -> np.ndarray:
    """The density kernel with no mask over the store batch's points,
    which stage as float32 as resident planes do (the counterpart ships
    them as float64); weights become float32, as its contributions do."""
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(device)
    wt = None if w is None else torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(device)
    return density_grid(xt, yt, env, width, height, weights=wt, lines=True).cpu().numpy()
