"""Phase 3f's map-client burst alone, repeated, on one tree.

    python -m geomesa_tpu_torch.tools.sched_burst_probe [--bursts 5] [--log2-rows 26]

Stages ``chip_smoke.py``'s 2^26 GDELT-shaped rows (its phase 3 generator,
seed and schemas) as phases 3 and 3c do: the z3 and z2 dim-plane indexes
and their interleaved siblings (``dim_planes=False``). Then it drives
phase 3f's burst (``chip_smoke.py`` ``drive_sched``: 64 map-client
threads of 16 loose tile counts and 16 threads of one loose feature
request, all at once, the default ``SchedConfig`` with ``max_queue``
2,048) once to warm, then ``--bursts`` times, and prints for each burst
the wall time, requests/s, launches, the fused groups' widths and the
submit-to-completion latency p50/p99 of counts and features, with the
garbage collector's pauses during it. Nothing else runs in the process,
so a burst's latency can be held against another tree's: run the probe
by path with ``PYTHONPATH`` at each tree's root, in turns, in one session
on one card. Answers are not checked here (``chip_smoke.py`` checks them).
The card's name and power limit are printed beside the numbers. Needs a
CUDA device and nvcc (``--device cpu`` rehearses it on the host's plain
versions); about a minute of staging.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _chip_smoke():
    """``chip_smoke.py`` beside the imported package (importing runs
    nothing): the generator, schemas and burst of its phases."""
    import geomesa_tpu_torch

    path = Path(geomesa_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bursts", type=int, default=5)
    p.add_argument("--log2-rows", type=int, default=26)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import torch

    import geomesa_tpu_torch
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.kernels import _build
    from geomesa_tpu_torch.sched import SchedConfig
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
    tree = Path(geomesa_tpu_torch.__file__).resolve().parents[1]
    print(f"burst probe ({tree}): {n:,} rows generated and staged in "
          f"{time.time() - t:.1f} s [{card}]", flush=True)
    pans, feats = cs.sched_traffic(cols["_centers"])
    n_req = sum(len(pn) for pn in pans) + sum(len(f) for f in feats)
    pct = cs.pct  # the percentile chip_smoke.py prints
    out = []
    for i in range(args.bursts + 1):
        pauses = []
        start = [0.0]

        def cb(phase, info):
            if phase == "start":
                start[0] = time.perf_counter()
            else:
                pauses.append(time.perf_counter() - start[0])

        gc.callbacks.append(cb)
        try:
            run = cs.drive_sched(idx, pans, feats, SchedConfig(max_queue=cs.SCHED_MAX_QUEUE))
            sync()
        finally:
            gc.callbacks.remove(cb)
        done, snap = run["done"], run["snap"]
        counts = [x[4] for x in done if x[1] == "count"]
        features = [x[4] for x in done if x[1] == "query"]
        widths: dict = {}
        for key, op, _, _, _, launch, fused in done:
            widths[(key, op, launch)] = fused
        row = {"burst": i, "warm": i == 0, "requests": n_req, "wall_ms": run["wall"] * 1e3,
               "requests_per_s": n_req / run["wall"], "launches": snap["launches"],
               "p50_ms": pct([x[4] for x in done], 50), "p99_ms": pct([x[4] for x in done], 99),
               "counts_p50_ms": pct(counts, 50), "features_p50_ms": pct(features, 50),
               "widths": sorted(widths.values(), reverse=True),
               "gc_pauses": len(pauses), "gc_ms": sum(pauses) * 1e3}
        out.append(row)
        print(f"burst probe {'warm' if i == 0 else i}: {row['wall_ms']:.1f} ms "
              f"({row['requests_per_s']:.1f} requests/s), {row['launches']} launches, p50 "
              f"{row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms (counts {row['counts_p50_ms']:.3f}, "
              f"features {row['features_p50_ms']:.3f}); widths {row['widths']}; "
              f"{row['gc_pauses']} collector pauses, {row['gc_ms']:.3f} ms [{card}]", flush=True)
    p50s = [r["p50_ms"] for r in out[1:]]
    print(json.dumps({"burst_probe": {"tree": str(tree), "p50_ms": p50s,
                                      "median_p50_ms": statistics.median(p50s), "card": card}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
