"""Checksummed, segmented write-ahead log for streaming ingest.

Copy of ``geomesa_tpu/store/wal.py`` (ref role: the commit log in front
of an LSM store, Accumulo's write-ahead log before the in-memory map,
Kafka's segment log as GeoMesa's live-layer transport). The contract:

- ``append(payload) -> seq`` returns only after the record is written
  (and fsynced when ``store.fsync`` is on, the durability point): a
  returned seq is an acked record and survives a SIGKILL anywhere.
- Records are length-prefixed and CRC-checksummed. Replay verifies every
  record; a torn tail (a crash mid-append) is truncated at the last valid
  checksum, so un-acked bytes vanish and acked bytes never do.
- Segments rotate at ``wal.segment.bytes`` (``wal-<firstseq>.seg``).
  ``truncate_through(seq)`` removes segments wholly consumed by a
  compaction; replay skips already-compacted records through the
  manifest's watermark (the caller's job: the log only orders and
  persists).

Record layout (little-endian), the counterpart's byte for byte:
``magic u32 | seq u64 | length u32 | crc32 u32 | payload``, the crc over
seq+length+payload, so a record can neither tear nor be misattributed to
another offset.

``read_from(after_seq)`` is the readonly cursor (the push tier's replay
and the registry's ``/wal/_pubsub`` ship) and ``pack_record`` the framing
of one record. The ``fail.wal.append`` / ``fail.wal.rotate`` /
``fail.wal.replay`` failpoints sit at the counterpart's steps. Left out:
``append_at`` and ``RecordParser``, whose only readers are the
replication tier's follower side (ROADMAP item 7).
"""

from __future__ import annotations

import logging
import os
import struct
import zlib

from geomesa_tpu_torch.failpoints import fail_point
from geomesa_tpu_torch.locking import checked_lock

__all__ = ["WriteAheadLog", "WalCorruption", "pack_record"]

_MAGIC = 0x474D5741  # "GMWA"
_HEADER = struct.Struct("<IQII")  # magic, seq, length, crc

_log = logging.getLogger(__name__)


class WalCorruption(RuntimeError):
    """A WAL segment failed validation somewhere other than a torn tail
    (an interior record with a bad checksum): replay stops at the damage
    rather than inventing rows past it."""


def _crc(seq: int, payload: bytes) -> int:
    c = zlib.crc32(struct.pack("<QI", seq, len(payload)))
    return zlib.crc32(payload, c) & 0xFFFFFFFF


def pack_record(seq: int, payload: bytes) -> bytes:
    """One record in the on-disk framing, the counterpart's byte for byte:
    the ship wire format is the segment format, so a reader verifies the
    same checksum replay does."""
    return _HEADER.pack(_MAGIC, seq, len(payload), _crc(seq, payload)) + payload


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _seg_name(first_seq: int) -> str:
    return f"wal-{first_seq:016d}.seg"


class WriteAheadLog:
    """One directory of rotating, checksummed log segments. Thread-safe:
    one appender lock orders the records (ordering the blocking writes is
    that lock's purpose)."""

    def __init__(self, directory: str, segment_bytes: "int | None" = None,
                 fsync: "bool | None" = None, readonly: bool = False):
        """``readonly`` opens for inspection only: no torn-tail truncation
        (a live appender's half-written record must never be cut from under
        its O_APPEND fd, which would land the rest of the record after the
        cut, inside an acked region), and ``append`` refuses."""
        self.dir = directory
        self._segment_bytes = segment_bytes
        self._fsync = fsync
        self._readonly = bool(readonly)
        self._lock = checked_lock("store.wal", blocking_ok=True)
        self._fd = -1
        self._seg_path: "str | None" = None
        self._seg_size = 0
        self._next_seq = 0
        #: sealed segments: path -> the last seq in it (the active segment
        #: excluded; truncate_through reads it)
        self._sealed: "dict[str, int]" = {}
        self.bytes_written = 0
        self.fsyncs = 0
        self.truncations = 0  # torn tails cut during a scan
        os.makedirs(directory, exist_ok=True)
        self._scan_segments()

    # -- config ------------------------------------------------------------

    def _seg_bytes(self) -> int:
        if self._segment_bytes is not None:
            return int(self._segment_bytes)
        from geomesa_tpu_torch.conf import sys_prop

        return max(int(sys_prop("wal.segment.bytes")), 1 << 12)

    def _sync_on(self) -> bool:
        if self._fsync is not None:
            return bool(self._fsync)
        from geomesa_tpu_torch.conf import sys_prop

        return bool(sys_prop("store.fsync"))

    # -- segment discovery -------------------------------------------------

    def segments(self) -> "list[str]":
        """Segment paths in seq order (the first seq is in the name)."""
        names = sorted(n for n in os.listdir(self.dir) if n.startswith("wal-") and n.endswith(".seg"))
        return [os.path.join(self.dir, n) for n in names]

    def _scan_segments(self) -> None:
        """Derive next_seq and the sealed-segment index from disk. Only the
        last segment may have a torn tail, which its scan truncates;
        interior bad records raise."""
        segs = self.segments()
        self._sealed = {}
        last_seq = -1
        for i, path in enumerate(segs):
            tail_ok = i == len(segs) - 1
            seg_last = -1
            for seq, _ in self._scan_one(path, truncate_tail=tail_ok):
                seg_last = seq
            if seg_last >= 0:
                last_seq = max(last_seq, seg_last)
            if not tail_ok:
                self._sealed[path] = seg_last
        self._next_seq = last_seq + 1
        if segs:  # appends continue into the last segment
            self._seg_path = segs[-1]
            self._seg_size = os.path.getsize(segs[-1])

    def _scan_one(self, path: str, truncate_tail: bool, mutate: bool = True):
        """Yield ``(seq, payload)`` for every valid record of one segment.
        With ``truncate_tail`` a trailing invalid record is cut at the last
        valid offset (counted); without it, damage raises
        :class:`WalCorruption`. ``mutate=False`` (and a readonly log) stops
        at a torn tail and never truncates."""
        from geomesa_tpu_torch import metrics

        good = 0
        with open(path, "rb") as fh:
            data = fh.read()
        off = 0
        n = len(data)
        while off < n:
            if off + _HEADER.size > n:
                break  # torn header
            magic, seq, length, crc = _HEADER.unpack_from(data, off)
            if magic != _MAGIC:
                break
            end = off + _HEADER.size + length
            if end > n:
                break  # torn payload
            payload = bytes(data[off + _HEADER.size:end])
            if _crc(seq, payload) != crc:
                break
            yield seq, payload
            off = end
            good = off
        if good < n:
            if not truncate_tail:
                raise WalCorruption(
                    f"WAL segment {path!r} damaged at offset {good} (of {n} bytes) before its tail")
            if self._readonly or not mutate:
                return  # inspect, never mutate: a live appender owns it
            _log.warning("WAL segment %r: torn tail truncated at offset %d (of %d bytes) -- "
                         "un-acked record dropped", path, good, n)
            with open(path, "r+b") as fh:
                fh.truncate(good)
            if self._sync_on():
                with open(path, "rb") as fh:
                    os.fsync(fh.fileno())
            self.truncations += 1
            metrics.stream_wal_truncations.inc()
            self._seg_size = good if path == self._seg_path else self._seg_size

    # -- append ------------------------------------------------------------

    def append(self, payload: bytes) -> int:
        """Durably append one record; returns its seq, the ack: with
        ``store.fsync`` on the record is on disk, off it is in the page
        cache (the same durability trade as the partition flushes).
        Transient I/O errors retry within the ``resilience`` backoff budget
        under the ``wal`` domain."""
        if self._readonly:
            raise RuntimeError("WAL opened readonly (inspection only)")
        with self._lock:
            seq = self._next_seq
            self._append_locked(seq, payload)
            return seq

    def _append_locked(self, seq: int, payload: bytes) -> None:
        """Write and ack one record (the caller holds the appender lock and
        ``seq == self._next_seq``); advances ``next_seq``."""
        from geomesa_tpu_torch import ledger, metrics, resilience

        rec = pack_record(seq, payload)

        def _write():
            # inside the retry: an injected (or real) transient failure
            # takes the backoff budget as a flaky disk would
            fail_point("fail.wal.append")
            self._rotate_if_needed(len(rec))
            start = self._seg_size
            try:
                self._write_record(rec)
            except BaseException:
                # a partial record must not stay ahead of the retry's full
                # copy: replay stops at the first damage, which would drop
                # the (acked) retry
                if self._fd >= 0:
                    try:
                        os.ftruncate(self._fd, start)
                        self._seg_size = start
                    except OSError:
                        pass
                raise

        resilience.retry_call(_write, domain="wal")
        self._next_seq = seq + 1
        self.bytes_written += len(rec)
        metrics.stream_wal_bytes.inc(len(rec))
        ledger.charge("wal_bytes", len(rec))
        if self._sync_on():
            self.fsyncs += 1
            metrics.stream_wal_fsyncs.inc()
            ledger.charge("wal_fsyncs", 1)

    def _write_record(self, rec: bytes) -> None:
        if self._fd < 0:
            self._open_segment()
        view = memoryview(rec)
        while view:
            view = view[os.write(self._fd, view):]
        if self._sync_on():
            os.fsync(self._fd)
        self._seg_size += len(rec)

    def _open_segment(self) -> None:
        if self._seg_path is None:
            self._seg_path = os.path.join(self.dir, _seg_name(self._next_seq))
            self._seg_size = 0
        self._fd = os.open(self._seg_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        if self._sync_on():
            _fsync_dir(self.dir)

    def _rotate_if_needed(self, incoming: int) -> None:
        if self._seg_path is None or self._fd < 0:
            return
        if self._seg_size == 0 or self._seg_size + incoming <= self._seg_bytes():
            return
        fail_point("fail.wal.rotate")
        # seal: the segment's records are durable one by one already; note
        # its last seq for truncate_through
        os.close(self._fd)
        self._fd = -1
        self._sealed[self._seg_path] = self._next_seq - 1
        self._seg_path = None
        self._open_segment()

    def sync(self) -> None:
        if self._fd >= 0:
            os.fsync(self._fd)
            self.fsyncs += 1

    # -- replay / GC -------------------------------------------------------

    def replay(self, after_seq: int = -1):
        """Yield ``(seq, payload)`` for every durable record with
        ``seq > after_seq``, in order. Torn tails are truncated (see
        ``_scan_one``); the caller treats records at or below its manifest
        watermark as compacted."""
        segs = self.segments()
        for i, path in enumerate(segs):
            fail_point("fail.wal.replay")
            tail_ok = i == len(segs) - 1
            for seq, payload in self._scan_one(path, truncate_tail=tail_ok):
                if seq > after_seq:
                    yield seq, payload

    def read_from(self, after_seq: int = -1):
        """Readonly cursor: yield ``(seq, payload)`` for every durable
        record with ``seq > after_seq``, in order, and never mutate,
        whether this is the live appender or a readonly inspector. A torn
        tail ends the stream (the next pass reads the retried copy); a
        segment unlinked mid-walk by ``truncate_through`` is skipped (its
        records are at or below the manifest watermark, which every reader
        of this cursor already holds)."""
        segs = self.segments()
        for i, path in enumerate(segs):
            try:
                for seq, payload in self._scan_one(path, truncate_tail=i == len(segs) - 1,
                                                   mutate=False):
                    if seq > after_seq:
                        yield seq, payload
            except FileNotFoundError:
                continue  # racing truncate_through

    def first_seq(self) -> int:
        """Lowest seq still on disk, or -1 when the log is empty (the first
        record of :meth:`read_from`)."""
        for seq, _ in self.read_from(-1):
            return seq
        return -1

    def truncate_through(self, seq: int) -> int:
        """Delete sealed segments whose every record is ``<= seq``
        (compacted into a published generation). The active segment is
        never deleted (it may be mid-append). Returns segments removed."""
        removed = 0
        with self._lock:
            for path, last in sorted(self._sealed.items()):
                if last <= seq:
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
                    del self._sealed[path]
                    removed += 1
            if removed and self._sync_on():
                _fsync_dir(self.dir)
        return removed

    # -- introspection -----------------------------------------------------

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def stats(self) -> dict:
        segs = self.segments()
        nbytes = 0
        live = 0
        for p in segs:
            try:
                nbytes += os.path.getsize(p)
                live += 1
            except FileNotFoundError:
                continue  # racing truncate_through
        return {
            "dir": self.dir,
            "segments": live,
            "bytes": int(nbytes),
            "next_seq": self._next_seq,
            "bytes_written": self.bytes_written,
            "fsyncs": self.fsyncs,
            "truncations": self.truncations,
        }

    def close(self) -> None:
        with self._lock:
            if self._fd >= 0:
                try:
                    if self._sync_on():
                        os.fsync(self._fd)
                finally:
                    os.close(self._fd)
                self._fd = -1
