"""The port's write-ahead log (``geomesa_tpu_torch/store/wal.py``) against
the JAX package's (``geomesa_tpu/store/wal.py``), on the CPU.

- The same opaque payloads give byte-identical segment files under the
  same names, and equal ``replay`` output, with and without rotation.
- Rotation, ``truncate_through``, ``first_seq`` and ``stats()`` agree.
- A torn tail (cut mid-record, mid-header) and a corrupt tail payload are
  truncated at the damage in both; interior damage raises
  ``WalCorruption`` in both; a readonly open never truncates and refuses
  appends.
- A transient ``fail.wal.append`` raise is retried inside the append (no
  partial record stays behind a failed write), and the ``wal`` breaker
  opens after persistent ones, in both packages' live layers.
"""

import os

import numpy as np
import pytest

from geomesa_tpu import failpoints as jfp
from geomesa_tpu import resilience as jres
from geomesa_tpu.store.wal import WalCorruption as JWalCorruption
from geomesa_tpu.store.wal import WriteAheadLog as JWAL
from geomesa_tpu_torch import failpoints, metrics, resilience
from geomesa_tpu_torch.store.wal import WalCorruption, WriteAheadLog


def _payloads(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(0, 900))) for _ in range(n)]


def _pair(tmp_path, **kw):
    return (WriteAheadLog(str(tmp_path / "port"), **kw), JWAL(str(tmp_path / "jax"), **kw))


def _files(wal) -> dict:
    return {os.path.basename(p): open(p, "rb").read() for p in wal.segments()}


def _stats(wal) -> dict:
    s = dict(wal.stats())
    s.pop("dir")
    return s


def _same(t, j):
    assert _files(t) == _files(j)
    assert list(t.replay()) == list(j.replay())
    assert t.next_seq == j.next_seq and t.first_seq() == j.first_seq()
    assert _stats(t) == _stats(j)


@pytest.mark.parametrize("segment_bytes", [None, 1 << 12], ids=["one-segment", "rotating"])
@pytest.mark.parametrize("fsync", [False, True])
def test_same_payloads_same_segments(tmp_path, segment_bytes, fsync):
    t, j = _pair(tmp_path, segment_bytes=segment_bytes, fsync=fsync)
    for p in _payloads(1):
        assert t.append(p) == j.append(p)
    _same(t, j)
    if segment_bytes:
        assert len(t.segments()) > 3
    assert [s for s, _ in t.replay(after_seq=17)] == list(range(18, 40))
    assert list(t.replay(after_seq=17)) == list(j.replay(after_seq=17))
    for w in (t, j):
        w.close()
    t, j = (WriteAheadLog(t.dir, segment_bytes=segment_bytes, fsync=fsync),
            JWAL(j.dir, segment_bytes=segment_bytes, fsync=fsync))
    assert t.append(b"after reopen") == j.append(b"after reopen") == 40
    _same(t, j)


@pytest.mark.parametrize("through", [-1, 5, 20, 39, 100])
def test_rotation_and_truncate_through(tmp_path, through):
    t, j = _pair(tmp_path, segment_bytes=1 << 12, fsync=False)
    for p in _payloads(2):
        t.append(p)
        j.append(p)
    assert t.truncate_through(through) == j.truncate_through(through)
    _same(t, j)
    assert t.segments()  # the active segment always stays
    t.append(b"x")
    j.append(b"x")
    _same(t, j)


def _cut(path, at):
    with open(path, "r+b") as fh:
        fh.truncate(at)


@pytest.mark.parametrize("where", ["mid-payload", "mid-header", "garbage"])
def test_a_torn_tail_truncates_at_the_last_valid_record(tmp_path, where):
    t, j = _pair(tmp_path, fsync=False)
    for p in _payloads(3, 6):
        t.append(p)
        j.append(p)
    sizes = {}
    for w in (t, j):
        w.close()
        [seg] = w.segments()
        sizes[w] = os.path.getsize(seg)
        if where == "garbage":
            with open(seg, "ab") as fh:
                fh.write(b"\x41\x57\x4d\x47torn")
        else:
            w2 = type(w)(w.dir, fsync=False)
            w2.append(b"y" * 300)
            w2.close()
            full = os.path.getsize(seg)
            _cut(seg, full - 100 if where == "mid-payload" else sizes[w] + 7)
    t, j = WriteAheadLog(t.dir, fsync=False), JWAL(j.dir, fsync=False)
    assert t.truncations == j.truncations == 1
    _same(t, j)
    assert os.path.getsize(t.segments()[0]) == sizes[next(iter(sizes))]
    assert t.append(b"after") == j.append(b"after") == 6
    _same(t, j)


def test_a_corrupt_tail_payload_truncates_at_the_damage(tmp_path):
    t, j = _pair(tmp_path, fsync=False)
    for w in (t, j):
        for p in _payloads(4, 5):
            w.append(p)
        w.close()
        [seg] = w.segments()
        data = bytearray(open(seg, "rb").read())
        data[-3] ^= 0xFF  # a payload byte of the last record
        open(seg, "wb").write(bytes(data))
    t, j = WriteAheadLog(t.dir, fsync=False), JWAL(j.dir, fsync=False)
    assert [s for s, _ in t.replay()] == [0, 1, 2, 3]
    assert t.truncations == j.truncations == 1
    _same(t, j)


def test_interior_damage_raises_in_both(tmp_path):
    t, j = _pair(tmp_path, segment_bytes=1 << 12, fsync=False)
    for w in (t, j):
        for p in _payloads(5):
            w.append(p)
        w.close()
        first = w.segments()[0]
        data = bytearray(open(first, "rb").read())
        data[40] ^= 0xFF
        open(first, "wb").write(bytes(data))
    with pytest.raises(WalCorruption, match="before its tail"):
        WriteAheadLog(t.dir, segment_bytes=1 << 12, fsync=False)
    with pytest.raises(JWalCorruption):
        JWAL(j.dir, segment_bytes=1 << 12, fsync=False)


def test_a_readonly_open_never_truncates(tmp_path):
    t, j = _pair(tmp_path, fsync=False)
    for w in (t, j):
        for p in _payloads(6, 4):
            w.append(p)
        w.close()
        with open(w.segments()[0], "ab") as fh:
            fh.write(b"half a record")
    sizes = [os.path.getsize(w.segments()[0]) for w in (t, j)]
    t, j = WriteAheadLog(t.dir, readonly=True), JWAL(j.dir, readonly=True)
    assert list(t.replay()) == list(j.replay()) and len(list(t.replay())) == 4
    assert [os.path.getsize(w.segments()[0]) for w in (t, j)] == sizes
    assert t.truncations == j.truncations == 0
    assert _stats(t) == _stats(j)
    with pytest.raises(RuntimeError, match="readonly"):
        t.append(b"x")
    with pytest.raises(RuntimeError, match="readonly"):
        j.append(b"x")


def test_a_partial_write_is_cut_before_the_retry(tmp_path):
    """A write that lands half a record and fails is cut back before the
    retry writes the whole record, so the segment holds it once."""
    t, j = _pair(tmp_path, fsync=False)
    for w in (t, j):
        w.append(b"first")
        real = w._write_record
        state = {"failed": False}

        def flaky(rec, w=w, real=real, state=state):
            if not state["failed"]:
                state["failed"] = True
                if w._fd < 0:
                    w._open_segment()
                os.write(w._fd, rec[: len(rec) // 2])
                raise OSError("disk hiccup")
            return real(rec)

        w._write_record = flaky
    for mod in (resilience, jres):
        mod.reset()
    from geomesa_tpu.conf import prop_override as jprop
    from geomesa_tpu_torch.conf import prop_override

    with prop_override("resilience.backoff.ms", 0.0), jprop("resilience.backoff.ms", 0.0):
        before = metrics.resilience_retries.value(domain="wal")
        assert t.append(b"second" * 50) == j.append(b"second" * 50) == 1
        assert metrics.resilience_retries.value(domain="wal") == before + 1
    _same(t, j)
    assert [p for _, p in t.replay()] == [b"first", b"second" * 50]


def _layer_pair(tmp_path):
    from _torch_fs_cases import pair

    from geomesa_tpu.store.stream import StreamingStore as JStreamingStore
    from geomesa_tpu_torch.store.stream import StreamingStore

    tds, jds = pair(str(tmp_path), "z3")
    return StreamingStore(tds), JStreamingStore(jds)


def test_fail_wal_append_retries_then_opens_the_breaker(tmp_path):
    from _torch_fs_cases import props, rows

    from geomesa_tpu.store.stream import WalUnavailableError as JWalUnavailable
    from geomesa_tpu_torch.store.stream import WalUnavailableError

    for mod in (resilience, jres):
        mod.reset()
    with props(resilience_backoff_ms=0.0, resilience_breaker_failures=3,
               resilience_breaker_cooldown_s=60.0, stream_memtable_rows=1 << 20):
        tl, jl = _layer_pair(tmp_path)
        try:
            cols = rows("z3", 20, seed=7)
            before = metrics.resilience_retries.value(domain="wal")
            with failpoints.failpoint_override("fail.wal.append", "raise:2"), \
                    jfp.failpoint_override("fail.wal.append", "raise:2"):
                assert tl.append("t", cols)["seq"] == jl.append("t", cols)["seq"] == 0
            assert metrics.resilience_retries.value(domain="wal") == before + 2
            with failpoints.failpoint_override("fail.wal.append", "raise"), \
                    jfp.failpoint_override("fail.wal.append", "raise"):
                for _ in range(3):  # each append spends its retries, then fails
                    with pytest.raises(failpoints.FailpointError):
                        tl.append("t", cols, fids=np.arange(100, 120))
                    with pytest.raises(jfp.FailpointError):
                        jl.append("t", cols, fids=np.arange(100, 120))
                assert resilience.wal_breaker().state == jres.wal_breaker().state == "open"
                with pytest.raises(WalUnavailableError):
                    tl.append("t", cols, fids=np.arange(100, 120))
                with pytest.raises(JWalUnavailable):
                    jl.append("t", cols, fids=np.arange(100, 120))
            assert tl.count("t") == jl.count("t") == 20  # only the acked append
            assert tl._streams["t"].wal.next_seq == jl._streams["t"].wal.next_seq == 1
        finally:
            tl.close()
            jl.close()
            for mod in (resilience, jres):
                mod.reset()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_record_equals_the_reference_byte_for_byte(seed):
    from geomesa_tpu.store.wal import pack_record as jpack
    from geomesa_tpu_torch.store.wal import pack_record

    rng = np.random.default_rng(seed)
    for p in _payloads(seed + 10, 12) + [b""]:
        seq = int(rng.integers(0, 1 << 40))
        assert pack_record(seq, p) == jpack(seq, p)


@pytest.mark.parametrize("segment_bytes", [None, 1 << 12], ids=["one-segment", "rotating"])
def test_read_from_equals_the_reference_and_the_segment_bytes(tmp_path, segment_bytes):
    """``read_from`` yields the records above a seq, as the reference's does;
    the packed records of a walk are the segment files' bytes."""
    from geomesa_tpu_torch.store.wal import pack_record

    t, j = _pair(tmp_path, segment_bytes=segment_bytes, fsync=False)
    for p in _payloads(9):
        t.append(p)
        j.append(p)
    for after in (-1, 0, 7, 38, 39, 100):
        assert list(t.read_from(after)) == list(j.read_from(after))
    assert b"".join(pack_record(s, p) for s, p in t.read_from(-1)) == \
        b"".join(open(p, "rb").read() for p in t.segments())
    assert t.truncate_through(20) == j.truncate_through(20)
    assert list(t.read_from(-1)) == list(j.read_from(-1))
    assert t.first_seq() == j.first_seq() == next(t.read_from(-1))[0]


def test_read_from_never_mutates_and_stops_at_a_torn_tail(tmp_path):
    """A torn tail ends the walk and stays on disk (the live appender owns
    it), in both packages; a segment unlinked mid-walk is skipped."""
    t, j = _pair(tmp_path, segment_bytes=1 << 12, fsync=False)
    for w in (t, j):
        for p in _payloads(11, 30):
            w.append(p)
        with open(w.segments()[-1], "ab") as fh:
            fh.write(b"GMWA half a record")
    sizes = [[os.path.getsize(p) for p in w.segments()] for w in (t, j)]
    assert list(t.read_from(-1)) == list(j.read_from(-1))
    assert len(list(t.read_from(-1))) == 30
    assert [[os.path.getsize(p) for p in w.segments()] for w in (t, j)] == sizes
    assert t.truncations == j.truncations == 0
    for w in (t, j):
        it = w.read_from(-1)
        first = next(it)
        os.unlink(w.segments()[1])  # a racing truncate_through
        rest = list(it)
        assert first[0] == 0 and rest and rest[-1][0] == 29
    assert [s for s, _ in t.read_from(-1)] == [s for s, _ in j.read_from(-1)]
