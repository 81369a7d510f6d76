"""The memory store's flush with the port's host index build against the
counterpart's plain build.

    python -m geomesa_tpu_torch.tools.build_probe [--log2-rows 26]

Writes ``chip_smoke.py``'s GDELT-shaped rows (its phase 3 generator, seed
and schema) into a ``MemoryDataStore`` on the CPU and times the flush
(the z3, z2 and id index builds side by side, then the write-time stats)
four times, in the order plain, port, port, plain:

- port: ``index/build.py`` as the store calls it (keys, stable sorts and
  gathers split into row ranges on ``HOST_WORKERS`` threads);
- plain: the counterpart's host path, ``geomesa_tpu/index/build.py``
  ``build_index`` without a mesh: keys over the whole column, one
  ``np.lexsort`` (``np.argsort(kind="stable")`` for one key column),
  ``FeatureBatch.take``.

Both give the same sorted rows; the probe checks every index's fids and
keys equal between the two. Prints the host's core count, each flush's
seconds and the peak resident set. Needs no card.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import os
import resource
import time
from pathlib import Path

import numpy as np


def _chip_smoke():
    """``chip_smoke.py`` beside the imported package (importing runs
    nothing): the generator and schema of its phase 3."""
    import geomesa_tpu_torch

    path = Path(geomesa_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_build_index(keyspace, batch, partition_size):
    """The counterpart's ``build_index`` with ``mesh=None`` and no native
    sort: whole-column keys, ``np.lexsort``, ``FeatureBatch.take``."""
    from geomesa_tpu_torch.index import build
    from geomesa_tpu_torch.index.api import BuiltIndex

    workers = build.HOST_WORKERS
    build.HOST_WORKERS = 1  # the key spaces' row ranges: one, the whole column
    try:
        keys = keyspace.index_keys(batch)
    finally:
        build.HOST_WORKERS = workers
    cols = [keys[c] for c in keyspace.key_columns]
    if len(cols) == 1:
        order = np.argsort(cols[0], kind="stable")
    else:
        order = np.lexsort(tuple(reversed(cols)))
    sorted_batch = batch.take(order)
    sorted_keys = {k: v[order] for k, v in keys.items()}
    parts = build.make_partitions(keyspace, sorted_batch, sorted_keys, partition_size)
    return BuiltIndex(keyspace, sorted_batch, sorted_keys, parts)


def flush(cols, spec, plain: bool):
    """Seconds of one write + flush, and the store."""
    from geomesa_tpu_torch.store import memory
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    port = memory.build_index
    if plain:
        memory.build_index = plain_build_index
    try:
        ds = MemoryDataStore(device="cpu")
        ds.create_schema("gdelt", spec)
        t = time.perf_counter()
        ds.write("gdelt", {k: cols[k] for k in ("count", "dtg", "geom")})
        ds.stats("gdelt")
        return time.perf_counter() - t, ds
    finally:
        memory.build_index = port


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log2-rows", type=int, default=26)
    args = p.parse_args(argv)
    from geomesa_tpu_torch.index import build

    smoke = _chip_smoke()
    n = 1 << args.log2_rows
    t = time.perf_counter()
    cols = smoke.make_columns(n, smoke.SEED)
    print(f"build probe: {n:,} rows generated in {time.perf_counter() - t:.1f} s; "
          f"{os.cpu_count()} cores, HOST_WORKERS {build.HOST_WORKERS}", flush=True)
    seconds = {"plain": [], "port": []}
    first = {}
    for kind in ("plain", "port", "port", "plain"):
        s, ds = flush(cols, smoke.GDELT_SPEC, kind == "plain")
        seconds[kind].append(s)
        st = ds._state("gdelt")
        got = {name: (idx.batch.fids, idx.keys) for name, idx in st.indices.items()}
        if first:
            for name, (fids, keys) in got.items():
                want_fids, want_keys = first[name]
                if not (np.array_equal(fids, want_fids)
                        and all(np.array_equal(keys[k], want_keys[k]) for k in want_keys)):
                    raise AssertionError(f"{name}: the {kind} build's order != the first build's")
        else:
            first = got
        del ds, st, got
        gc.collect()
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
        print(f"build probe: {kind} flush {s:.3f} s (peak RSS so far {peak:.1f} GB)", flush=True)
    print(f"build probe: flush at {n:,} rows, plain {[round(v, 3) for v in seconds['plain']]} s, "
          f"port {[round(v, 3) for v in seconds['port']]} s; every index's fids and keys equal "
          f"({os.cpu_count()} cores)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
