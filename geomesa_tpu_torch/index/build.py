"""Index build: key compute -> global sort -> partition manifest.

Copy of ``geomesa_tpu/index/build.py``, the host path only: ``build_index``
without a mesh, ``_sort_order`` and ``make_partitions`` (ref: GeoMesa's
bulk-ingest sort and table splits). The device build on the card (the
counterpart's ``build_index_device``) is not in the port yet.

The order is numpy's stable sort, as the counterpart's ``lexsort`` (or its
optional native radix sort) gives it. At scale the host work runs on
``HOST_WORKERS`` threads (numpy releases the GIL in its sorts, gathers and
ufuncs): the key of each row range is computed apart, each range is
argsorted stably, and one stable timsort merges the sorted runs, ties in
row order; a lexicographic key sorts its columns from the last to the
first, each stably, the bins as a 16-bit radix sort where their span
allows. The order equals a single stable lexsort's, bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.index.api import BuiltIndex, PartitionMeta

DEFAULT_PARTITION_SIZE = 1 << 20  # ~1M rows per partition

#: threads of the host build; ranges smaller than PARALLEL_MIN_ROWS run inline
HOST_WORKERS = min(8, os.cpu_count() or 1)
PARALLEL_MIN_ROWS = 1 << 20


def row_ranges(n: int) -> "list[tuple[int, int]]":
    """[start, stop) row ranges splitting n rows among the host workers
    (one range below PARALLEL_MIN_ROWS rows)."""
    k = HOST_WORKERS if n >= PARALLEL_MIN_ROWS else 1
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def map_ranges(fn, n: int) -> list:
    """``[fn(start, stop) for each row range]``, on the host workers."""
    ranges = row_ranges(n)
    if len(ranges) == 1:
        return [fn(*ranges[0])]
    with ThreadPoolExecutor(len(ranges)) as ex:
        return list(ex.map(lambda r: fn(*r), ranges))


def concat_ranges(fn, n: int):
    """The per-range results of ``fn`` concatenated (arrays or dicts of
    arrays with the same keys)."""
    parts = map_ranges(fn, n)
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def take_rows(batch: FeatureBatch, order: np.ndarray) -> FeatureBatch:
    """``batch.take(order)`` with each column gathered by the host workers."""
    arrays = {"__fids__": batch.fids, **batch.columns}
    out = {k: np.empty((len(order),) + v.shape[1:], dtype=v.dtype) for k, v in arrays.items()}

    def gather(a: int, b: int) -> None:
        for k, v in arrays.items():
            np.take(v, order[a:b], axis=0, out=out[k][a:b])

    map_ranges(gather, len(order))
    fids = out.pop("__fids__")
    return FeatureBatch(batch.sft, fids, out)


def build_index(
    keyspace,
    batch: FeatureBatch,
    partition_size: int = DEFAULT_PARTITION_SIZE,
) -> BuiltIndex:
    keys = keyspace.index_keys(batch)
    cols = [keys[c] for c in keyspace.key_columns]
    order = _sort_order(cols)
    sorted_batch = take_rows(batch, order)
    sorted_keys = concat_ranges(
        lambda a, b: {k: v[order[a:b]] for k, v in keys.items()}, len(order)
    )
    partitions = make_partitions(keyspace, sorted_batch, sorted_keys, partition_size)
    return BuiltIndex(keyspace, sorted_batch, sorted_keys, partitions)


def _sort_order(cols: list) -> np.ndarray:
    """Stable lexicographic order of rows over ``cols`` (the first column
    primary): np.lexsort's, bit for bit."""
    order = _stable_argsort(cols[-1])
    for col in reversed(cols[:-1]):
        order = order[_stable_argsort(col[order])]
    return order


def _stable_argsort(key: np.ndarray) -> np.ndarray:
    """np.argsort(key, kind="stable"), sorted by row ranges on the host
    workers and merged by one stable timsort over the sorted runs."""
    if key.dtype.kind in "iu" and len(key):
        lo, hi = int(key.min()), int(key.max())
        if hi - lo < 1 << 15:  # a 16-bit key: numpy's stable sort is a radix sort
            return np.argsort((key - lo).astype(np.int16), kind="stable")
    ranges = row_ranges(len(key))
    if len(ranges) == 1:
        return np.argsort(key, kind="stable")
    idx = concat_ranges(lambda a, b: np.argsort(key[a:b], kind="stable") + a, len(key))
    # equal keys keep row order: within a range by the first sort, across
    # ranges because earlier ranges come first in idx
    return idx[np.argsort(key[idx], kind="stable")]


def make_partitions(
    keyspace,
    sorted_batch: FeatureBatch,
    sorted_keys: dict,
    partition_size: int,
) -> "list[PartitionMeta]":
    n = len(sorted_batch)
    sft = sorted_batch.sft
    geom = sft.geom_field
    dtg = sft.dtg_field
    key_cols = [sorted_keys[c] for c in keyspace.key_columns]
    starts = np.arange(0, max(n, 1), partition_size)
    starts = starts[starts < max(n, 1)]
    # per-partition reductions via reduceat: one pass per statistic over
    # the whole column instead of materializing an (n, 4) bbox array (a
    # full extra copy of the coordinate data) and slicing it per partition
    bb_mins = bb_maxs = None
    if geom is not None and n:
        col = sorted_batch.columns[geom]
        if col.dtype != object:
            x = np.ascontiguousarray(col[:, 0])
            y = np.ascontiguousarray(col[:, 1])
            bb_mins = (
                np.minimum.reduceat(x, starts), np.minimum.reduceat(y, starts)
            )
            bb_maxs = (
                np.maximum.reduceat(x, starts), np.maximum.reduceat(y, starts)
            )
        else:
            bb = sorted_batch.bboxes(geom)
            bb_mins = (
                np.minimum.reduceat(bb[:, 0], starts),
                np.minimum.reduceat(bb[:, 1], starts),
            )
            bb_maxs = (
                np.maximum.reduceat(bb[:, 2], starts),
                np.maximum.reduceat(bb[:, 3], starts),
            )
    t_mins = t_maxs = None
    if dtg is not None and n:
        d_all = sorted_batch.column(dtg)
        t_mins = np.minimum.reduceat(d_all, starts)
        t_maxs = np.maximum.reduceat(d_all, starts)
    partitions = []
    for pid, start in enumerate(starts.tolist() if n else [0]):
        stop = min(start + partition_size, n)
        if stop <= start:
            break
        key_lo = tuple(_item(c[start]) for c in key_cols)
        key_hi = tuple(_item(c[stop - 1]) for c in key_cols)
        bbox = None
        if bb_mins is not None:
            bbox = (
                float(bb_mins[0][pid]), float(bb_mins[1][pid]),
                float(bb_maxs[0][pid]), float(bb_maxs[1][pid]),
            )
        time_range = None
        if t_mins is not None:
            time_range = (int(t_mins[pid]), int(t_maxs[pid]))
        partitions.append(
            PartitionMeta(pid, start, stop, key_lo, key_hi, stop - start, bbox, time_range)
        )
    return partitions


def _item(v):
    """numpy scalar -> python scalar for tuple comparisons; uint64 z values
    stay exact via int()."""
    if isinstance(v, np.generic):
        return v.item()
    return v
