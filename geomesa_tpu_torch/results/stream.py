"""Streamed wire encoders: BIN record streams.

Counterpart of ``geomesa_tpu/results/stream.py``, trimmed to
:func:`bin_stream_chunks` and the byte sink :class:`_ChunkSink`. Its
``arrow_stream_chunks`` (reference line 61) and
``write_arrow_stream_file`` need ``pyarrow``, which the card's host does
not have: the server answers an Arrow request 406 (ROADMAP section 3).
"""

from __future__ import annotations


class _ChunkSink:
    """Minimal binary sink handing written bytes to the consumer in write
    order."""

    closed = False

    def __init__(self):
        self._parts: list = []

    def write(self, data) -> int:
        b = bytes(data)
        self._parts.append(b)
        return len(b)

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return False

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def drain(self) -> bytes:
        if not self._parts:
            return b""
        out = b"".join(self._parts)
        self._parts.clear()
        return out


def bin_stream_chunks(
    batches,
    track_attr: str,
    *,
    dtg_attr: "str | None" = None,
    geom_attr: "str | None" = None,
    label_attr: "str | None" = None,
    sort: bool = False,
):
    """Yield BIN track-record bytes per input batch (16B or 24B records).
    ``sort`` orders within each batch: a globally dtg-sorted output is the
    resident rider's job (one result set, one batch there)."""
    from geomesa_tpu_torch.process.binexport import encode_bin

    it = iter(batches)
    try:
        for b in it:
            if not len(b):
                continue
            yield encode_bin(
                b, track_attr, dtg_attr=dtg_attr, geom_attr=geom_attr,
                label_attr=label_attr, sort=sort,
            )
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
