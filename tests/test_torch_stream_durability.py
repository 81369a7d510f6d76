"""The port's live layer survives a SIGKILL anywhere: a child process that
runs port code only (an import of ``jax``, ``pyarrow`` or ``geomesa_tpu``
fails in it) appends to a ``StreamingStore`` and is killed at a
failpoint; the layer reopened in this process serves exactly the rows
the child saw acked, each once.

- ``fail.wal.append``: killed inside an append (the record not acked);
- ``fail.wal.rotate``: killed sealing a full segment (small segments);
- ``fail.compact.publish``: killed after the compaction published its
  generation and before the WAL was truncated (the watermark skips the
  compacted records at replay);
- ``fail.wal.replay``: killed while a reopen replays the WAL, then opened
  again;
- a clean exit with no ``close``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.stream import StreamingStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "val:Int,dtg:Date,*geom:Point:srid=4326"
BASE = 300

_CHILD = r"""
import sys


class _PortOnly:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pyarrow", "geomesa_tpu"):
            raise ImportError(f"a port-only child imported {name}")
        return None


sys.meta_path.insert(0, _PortOnly())
import numpy as np
from geomesa_tpu_torch import failpoints
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.stream import StreamingStore

root, action, arm_after = sys.argv[1], sys.argv[2], int(sys.argv[3])
layer = StreamingStore(FileSystemDataStore(root, partition_size=128, device="cpu"))
layer._compact_due = lambda ts: False  # this script picks the compaction's instant
rng = np.random.default_rng(7)
for i in range(12):
    if i == arm_after and action in ("fail.wal.append", "fail.wal.rotate"):
        failpoints.set_failpoint(action, "kill")
    n = 40
    fid0 = 10_000 + 100 * i
    r = layer.append("t", {"val": rng.integers(0, 100, n), "dtg": rng.integers(0, 10**9, n),
                           "geom": rng.uniform([-180, -90], [180, 90], (n, 2))},
                     fids=np.arange(fid0, fid0 + n))
    print("ACK", r["seq"], fid0, n, flush=True)
    if i + 1 == arm_after and action == "fail.compact.publish":
        failpoints.set_failpoint(action, "kill")
        layer.compact_now("t")
        print("compacted without dying", flush=True)
        sys.exit(3)
if action == "exit":
    sys.exit(0)  # no close: the WAL alone holds the acked rows
print("ran to the end without dying", flush=True)
sys.exit(3)
"""


def _store(root):
    ds = FileSystemDataStore(root, partition_size=128, device="cpu")
    ds.create_schema("t", SPEC)
    rng = np.random.default_rng(1)
    ds.write("t", {"val": rng.integers(0, 100, BASE), "dtg": rng.integers(0, 10**9, BASE),
                   "geom": rng.uniform([-180, -90], [180, 90], (BASE, 2))})
    ds.flush("t")


def _child(root, action, arm_after, env_extra=None, script=_CHILD):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               GEOMESA_TPU_STREAM_MEMTABLE_ROWS=str(1 << 20), GEOMESA_TPU_STREAM_RUN_ROWS="80")
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", script, root, action, str(arm_after)], env=env,
                          capture_output=True, text=True, timeout=120)


def _acked(proc) -> set:
    fids = set()
    for line in proc.stdout.splitlines():
        if line.startswith("ACK "):
            _, _, fid0, n = line.split()
            fids |= set(range(int(fid0), int(fid0) + int(n)))
    return fids


def _serves_exactly(root, acked) -> StreamingStore:
    layer = StreamingStore(FileSystemDataStore(root, partition_size=128, device="cpu"))
    fids = layer.query("t", "INCLUDE").batch.fids.tolist()
    assert len(fids) == len(set(fids)) == layer.count("t") == BASE + len(acked)
    assert set(fids) == set(range(BASE)) | acked
    return layer


@pytest.mark.parametrize("action,arm_after,extra", [
    ("fail.wal.append", 5, None),
    ("fail.wal.rotate", 0, {"GEOMESA_TPU_WAL_SEGMENT_BYTES": "4096"}),
    ("fail.compact.publish", 6, None),
])
def test_a_killed_child_leaves_exactly_the_acked_rows(tmp_path, action, arm_after, extra):
    root = str(tmp_path / "store")
    _store(root)
    proc = _child(root, action, arm_after, extra)
    assert proc.returncode == -9, proc.stdout[-2000:] + proc.stderr[-2000:]
    acked = _acked(proc)
    assert acked if action != "fail.wal.rotate" else True
    layer = _serves_exactly(root, acked)
    try:
        if action == "fail.compact.publish":
            # published: the watermark covers the compacted records, which
            # stay in the untruncated WAL and are skipped by the replay
            assert layer.store._types["t"].wal_watermark == 5
            assert not layer._runs_snapshot("t")
            assert layer._streams["t"].wal.first_seq() == 0
        if action == "fail.wal.rotate":
            assert len(acked) < 12 * 40  # killed before the last append
        layer.compact_now("t")
        assert layer.count("t") == BASE + len(acked)
    finally:
        layer.close()
    _serves_exactly(root, acked).close()


def test_a_clean_exit_without_close_then_a_kill_during_replay_lose_nothing(tmp_path):
    root = str(tmp_path / "store")
    _store(root)
    proc = _child(root, "exit", 0)
    assert proc.returncode == 0, proc.stderr[-2000:]
    acked = _acked(proc)
    assert len(acked) == 12 * 40
    _serves_exactly(root, acked).close()  # the WAL alone held them
    killed = _child(root, "replay", 0, {"GEOMESA_TPU_FAILPOINTS": "fail.wal.replay=kill"})
    assert killed.returncode == -9 and "ACK" not in killed.stdout, killed.stderr[-2000:]
    _serves_exactly(root, acked).close()
