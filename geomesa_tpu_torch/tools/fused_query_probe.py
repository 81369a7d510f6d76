"""The fused loose query's demux at full size: time and device memory of
three ways to turn the (Q, n) hit matrix into each query's rows.

    python -m geomesa_tpu_torch.tools.fused_query_probe [--log2-rows 26] [--repeats 3]

Stages ``chip_smoke.py``'s 2^26 GDELT-shaped rows (its phase 3 generator,
seed and schemas) as phases 3 and 3c do: the z3 and z2 dim-plane indexes
and their interleaved siblings. Then, for each group of queries, it
launches the fused mask once (``DeviceIndex._fused_loose``) and demuxes
the same matrix three ways, each checked equal to the others:

- ``host_copy``: the whole matrix copied to the host, one ``np.nonzero`` a
  row (the JAX package's ``fused_loose_query``);
- ``nonzero_all``: one ``torch.nonzero`` over the whole matrix on the
  device, its (query, row) pairs copied (16 bytes a hit on the device);
- ``runs``: ``DeviceIndex._fused_hits``, the port's: ``torch.nonzero``
  over blocks of rows of at most ``_FUSED_HIT_PAIRS`` cells, a row alone
  where a row holds more.

The groups: phase 3f's loose feature requests (``chip_smoke.py``
``sched_traffic``), one group per index as the scheduler fuses them; the
warmup's ``fused_query:q=64`` leg (64 copies of the city box, 0.05 degrees
about the first row, over the staged dates' whole interval) on the z3
dim-plane and interleaved indexes; and 64 wide boxes (40 by 20 degrees
about each city centre, the whole interval) on the z3 index, where the
hits run to 10^8 at 2^26 rows. For each it prints the hits, the
mask launch's ms, each demux's ms (median of ``--repeats``) and its peak
device memory above the matrix (``torch.cuda.max_memory_allocated``), and
``fused_loose_query``'s ms end to end where the group's rows fit a host
take. The card's name and power limit are printed beside the numbers.
Needs a CUDA device and nvcc (``--device cpu`` rehearses it on the host's
plain versions at a small ``--log2-rows``); about a minute of staging.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _chip_smoke():
    """``chip_smoke.py`` beside the imported package (importing runs
    nothing): the generator, schemas and traffic of its phases."""
    import geomesa_tpu_torch

    path = Path(geomesa_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_copy(m):
    mh = m.cpu().numpy()
    return [np.nonzero(r)[0] for r in mh]


def _nonzero_all(m):
    import torch

    hits = torch.nonzero(m).cpu().numpy()
    cuts = np.searchsorted(hits[:, 0], np.arange(1, m.shape[0]))
    return np.split(hits[:, 1], cuts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log2-rows", type=int, default=26)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import torch

    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.kernels import _build
    from geomesa_tpu_torch.store.direct import BatchStore

    cs = _chip_smoke()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    card = _card() if on_card else "the host's plain versions"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        _build.build_all()
    n = 1 << args.log2_rows
    t = time.time()
    cols = cs.make_columns(n, cs.SEED)
    b3 = FeatureBatch.from_columns(SimpleFeatureType.create("gdelt", cs.GDELT_SPEC),
                                   {k: cols[k] for k in ("count", "dtg", "geom")})
    b2 = FeatureBatch.from_columns(SimpleFeatureType.create("points", cs.Z2_SPEC),
                                   {k: cols[k] for k in ("count", "geom")})
    s3, s2 = BatchStore(b3), BatchStore(b2)
    idx = {"z3": DeviceIndex(s3, "gdelt", z_planes=True, device=dev),
           "z2": DeviceIndex(s2, "points", z_planes=True, device=dev),
           "z3i": DeviceIndex(s3, "gdelt", z_planes=True, device=dev, dim_planes=False),
           "z2i": DeviceIndex(s2, "points", z_planes=True, device=dev, dim_planes=False)}
    sync()
    print(f"fused query probe: {n:,} rows generated and staged in {time.time() - t:.1f} s [{card}]",
          flush=True)

    _, feats = cs.sched_traffic(cols["_centers"])
    groups = []
    for key in cs.SCHED_INDEXES:
        qs = [q for f in feats for k, q in f if k == key]
        groups.append((f"3f features {key}", key, qs, True))
    t0, t1 = int(cols["dtg"].min()), int(cols["dtg"].max())
    x0, y0 = (float(v) for v in cols["geom"][0])
    city = ast.And([ast.BBox("geom", x0 - 0.05, y0 - 0.05, x0 + 0.05, y0 + 0.05),
                    ast.During("dtg", t0, t1)])
    for key in ("z3", "z3i"):
        groups.append((f"warmup fused_query:q=64 {key}", key, [city] * 64, True))
    wide = [ast.And([ast.BBox("geom", cx - 20.0, cy - 10.0, cx + 20.0, cy + 10.0),
                     ast.During("dtg", t0, t1)]) for cx, cy in cols["_centers"]]
    groups.append(("wide boxes q=64 z3", "z3", wide, False))

    ways = {"host_copy": _host_copy, "nonzero_all": _nonzero_all, "runs": DeviceIndex._fused_hits}
    rows = []
    for name, key, qs, take in groups:
        di = idx[key]
        sync()
        t = time.perf_counter()
        m = di._fused_loose(qs, True, want="mask")
        sync()
        mask_ms = (time.perf_counter() - t) * 1e3
        if m is None:
            raise AssertionError(f"fused query probe: the group {name!r} did not fuse")
        row = {"group": name, "q": len(qs), "rows": n, "mask_ms": mask_ms}
        answers = {}
        for way, fn in ways.items():
            ms, peaks = [], []
            for _ in range(args.repeats):
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated() if on_card else 0
                t = time.perf_counter()
                got = fn(m)
                sync()
                ms.append((time.perf_counter() - t) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() - base if on_card else 0)
                answers[way] = got
            row[f"{way}_ms"] = statistics.median(ms)
            row[f"{way}_peak_bytes"] = max(peaks)
        ref = answers["host_copy"]
        for way, got in answers.items():
            if len(got) != len(ref) or not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"fused query probe: {way} != host_copy in {name!r}")
        row["hits"] = int(sum(len(a) for a in ref))
        answers.clear()
        del m
        if take:
            ms = []
            for _ in range(args.repeats):
                sync()
                t = time.perf_counter()
                di.fused_loose_query(qs, loose=True)
                sync()
                ms.append((time.perf_counter() - t) * 1e3)
            row["fused_loose_query_ms"] = statistics.median(ms)
        rows.append(row)
        print(f"fused query probe {name}: Q {row['q']}, {row['hits']:,} hits; mask {mask_ms:.3f} ms; "
              + "; ".join(f"{w} {row[f'{w}_ms']:.3f} ms, peak +{row[f'{w}_peak_bytes'] / 2**20:.1f} MiB"
                          for w in ways)
              + (f"; fused_loose_query {row['fused_loose_query_ms']:.3f} ms" if take else "")
              + f" [{card}]", flush=True)
    print(json.dumps({"fused_query_probe": rows, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
