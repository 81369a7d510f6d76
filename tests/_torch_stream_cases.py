"""Shared inputs of the live-layer parity tests
(``tests/test_torch_stream_*.py``): a pair of layers (the JAX package's
``StreamingStore`` over its ``FileSystemDataStore`` under ``tmp_path``,
the port's over its own on ``device="cpu"``), the acked append carried
from the JAX package's layer to the port's, and the comparisons.

The JAX package's WAL payload is an Arrow IPC record, the port's a
partition-file block (ROADMAP section 3), so state crosses as rows: the
JAX package's layer appends, its acked WAL record is decoded by its own
``_decode``, and the port's layer appends those rows.
"""

from __future__ import annotations

import os

import numpy as np
from _torch_fs_cases import pair, rows

from geomesa_tpu.geom import to_wkt
from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu.store.stream import IngestBackpressureError as JBackpressure
from geomesa_tpu.store.stream import StreamingStore as JStreamingStore
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.stream import IngestBackpressureError, StreamingStore


def hold_daemon(layer) -> None:
    """Keep the layer's compactor daemon from compacting on its own (its
    due test answers no): the test picks every compaction's instant."""
    layer._compact_due = lambda ts: False


def layers(tmp_path, kind: str, n0: int = 200, seed: int = 1, labels: bool = False,
           psize: int = 64):
    """(port layer, JAX layer) over a store pair with ``n0`` flushed rows
    of ``kind`` in type ``t``; both daemons held."""
    tds, jds = pair(str(tmp_path), kind, psize=psize)
    if n0:
        cols = rows(kind, n0, seed, labels=labels)
        for ds in (tds, jds):
            ds.write("t", cols)
            ds.flush("t")
    return wrap(tds, jds)


def wrap(tds, jds):
    tl, jl = StreamingStore(tds), JStreamingStore(jds)
    hold_daemon(tl)
    hold_daemon(jl)
    return tl, jl


def reopen(tl, jl, psize: int = 64):
    """Close both layers without compacting and open new stores and layers
    on their roots (the WAL replays)."""
    for lay in (tl, jl):
        lay.close(compact=False)
    return wrap(FileSystemDataStore(tl.store.root, partition_size=psize, device="cpu"),
                JFS(jl.store.root, partition_size=psize))


def port_columns(jb) -> dict:
    """A JAX package batch's columns as the port's layer takes them
    (geometries other than points as WKT)."""
    out = {}
    for k, v in jb.columns.items():
        attr = jb.sft.descriptor(k) if k in {a.name for a in jb.sft.attributes} else None
        if attr is not None and attr.is_geometry and v.dtype == object:
            v = np.array([to_wkt(g) for g in v], dtype=object)
        out[k] = v
    return out


def acked_record(jl, seq: int) -> bytes:
    for s, payload in jl._streams["t"].wal.read_from(seq - 1):
        if s == seq:
            return payload
    raise KeyError(seq)


def carry(tl, jl, cols, fids) -> "tuple[dict, dict] | None":
    """One append in both layers. The JAX package's layer appends
    ``cols``; its acked record, decoded by its own ``_decode``, is what the
    port's layer appends. A shed append must shed in both (None)."""
    try:
        jr = jl.append("t", cols, fids=fids)
    except JBackpressure:
        try:
            tl.append("t", cols, fids=fids)
        except IngestBackpressureError:
            return None
        raise AssertionError("the JAX package's layer shed an append the port's acked")
    jb = jl._decode("t", acked_record(jl, jr["seq"]))
    tr = tl.append("t", port_columns(jb), fids=jb.fids)
    assert tr == jr
    return tr, jr


def manifest_watermark(ds) -> int:
    import json

    with open(os.path.join(ds.root, "t", "schema.json")) as fh:
        return int(json.load(fh)["wal_watermark"])


def same_stream_stats(tl, jl) -> None:
    """``stream_stats`` of type ``t`` equal in both layers, byte sizes
    aside: the payloads differ by design (partition-file blocks against
    Arrow IPC), so the WAL's bytes and its segment count may differ."""
    a, b = tl.stream_stats()["types"].get("t"), jl.stream_stats()["types"].get("t")
    assert (a is None) == (b is None)  # a type's stream opens at its first append or replay
    if a is None:
        return
    for k in ("memtable_rows", "runs", "wal_watermark", "appended_rows", "compactions"):
        assert a[k] == b[k], k
    for k in ("next_seq", "fsyncs", "truncations"):
        assert a["wal"][k] == b["wal"][k], k
    assert tl.stream_stats()["max_generations"] == jl.stream_stats()["max_generations"]
