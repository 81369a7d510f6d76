"""Where a call of the Q-batched dim scan spends its time.

    python -m geomesa_tpu_torch.tools.dimscan_batched_probe

Stages ``chip_smoke.py``'s 2^26 GDELT-shaped rows (its phase 3 generator,
seed and schemas) as phase 3f's dim-plane indexes: z3 (nx, ny, bt planes)
and its date-less z2 sibling (nx, ny). Groups are phase 3f's map-client
tiles, one tile of each pan in turn, as phase 4 takes them. At Q in {1, 4,
8, 64}, for z3 at R = 1 and at R = 2 (each query's bt range split in two:
the same rows) and for z2, count and mask, without and with a validity
plane (50% of the rows live at random), it times:

1. the call as phase 4 times it (``batched_dimscan_count`` / ``_mask`` on
   the group's query vectors: packing, upload, launch), CUDA events over
   back-to-back calls;
2. the launch alone: the group packed and its table on the card before the
   timed loop, CUDA events;
3. the host's packing and upload alone: the host clock around packing, the
   upload and a synchronise, median of 20.

Then the two ways of the kernel one against the other (the launch alone,
each way forced: ``batched_dimscan(qmat, compare=...)``) at Q from 1 to
64, z3 at R = 1 and 2 and z2, count and mask, where the group's shape
chooses between them (``zscan.DIMSCAN_COUNT_COMPARE_MAX``,
``DIMSCAN_MASK_COMPARE_MAX``), and the time to fill
a (64, n) byte matrix (``torch.Tensor.fill_``), the masks' write
yardstick; ``--calls-only`` leaves this part out.

Every answer is checked against the package's plain version
(``batched_dim_mask_rt``) first. The probe runs against the package it
imports, so that two trees can be timed on one card in turns (``PYTHONPATH``
at each tree's root, the probe run by its path); a package that does not
pack groups (``batched_dimscan``) gets the call alone. Prints one line per
row and one JSON line of every row, with the card's name and power limit.
Needs a CUDA device and nvcc; about a minute of staging.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

QS = (1, 4, 8, 64)
AB_QS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


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


def _events(fn, iters: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host(fn, reps: int = 20) -> float:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _ab(zscan, groups, card: str) -> dict:
    """The launch alone with each way forced, count and mask, at AB_QS;
    each answer checked against the plain version."""
    import torch

    rows = {}
    for nq in AB_QS:
        for kind, r, qm, planes in groups:
            qmat = qm[:nq]
            want = zscan.batched_dim_mask_rt(r)(*planes, qmat)
            line = []
            for compare in (True, False):
                pk = zscan.batched_dimscan(qmat, compare=compare)
                for want_mask in (False, True):
                    ref = want if want_mask else want.sum(dim=1, dtype=torch.int32)
                    if not torch.equal(pk.run(planes, want_mask), ref):
                        raise AssertionError(f"A/B {kind} Q={nq} compare={compare}: != the plain version")
                    ms = _events(lambda pk=pk, m=want_mask: pk.run(planes, m), 20 if nq > 16 else 50)
                    way = "compare" if compare else "lookup"
                    rows[f"{kind} Q={nq} {way} {'mask' if want_mask else 'count'}"] = ms
                    line.append(f"{way} {'mask' if want_mask else 'count'} {ms:.4f}")
            pk = zscan.batched_dimscan(qmat)
            chosen = "/".join("compare" if pk.takes_compare(m) else "lookup" for m in (False, True))
            print(f"  A/B {kind} Q={nq} ({nq * (4 + 2 * r)} compares a row; the shape picks {chosen}): "
                  + ", ".join(line) + f" ms [{card}]", flush=True)
            del want
            torch.cuda.empty_cache()
    n = groups[0][3][0].shape[0]
    buf = torch.empty((64, n), dtype=torch.bool, device=groups[0][3][0].device)
    rows["fill (64, n) bytes"] = _events(lambda: buf.fill_(True), 20)
    print(f"  fill of a (64, {n:,}) byte matrix: {rows['fill (64, n) bytes']:.4f} ms [{card}]", flush=True)
    return rows


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="time the batched dim scan's calls")
    ap.add_argument("--calls-only", action="store_true", help="leave out the A/B of the two ways")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dimscan_batched_probe: no CUDA device", file=sys.stderr)
        return 2
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.kernels import _build
    from geomesa_tpu_torch.ops import zscan
    from geomesa_tpu_torch.store.direct import BatchStore

    cs = _chip_smoke()
    dev = torch.device("cuda:0")
    card = _card()
    packed = hasattr(zscan, "batched_dimscan")  # else: the call alone, no A/B
    _build.build_all()
    t = time.time()
    cols = cs.make_columns(cs.N_ROWS, cs.SEED)
    idx = {}
    for key, spec, names in (("z3", cs.GDELT_SPEC, ("count", "dtg", "geom")),
                             ("z2", cs.Z2_SPEC, ("count", "geom"))):
        batch = FeatureBatch.from_columns(SimpleFeatureType.create("t", spec),
                                          {k: cols[k] for k in names})
        idx[key] = DeviceIndex(BatchStore(batch), "t", z_planes=True, device=dev)
    torch.cuda.synchronize()
    n = len(idx["z3"])
    print(f"dimscan batched probe ({zscan.__file__}): {n:,} rows staged in "
          f"{time.time() - t:.1f} s [{card}]", flush=True)
    pans, _ = cs.sched_traffic(cols["_centers"])
    tiles = {k: [pan[j][1] for j in range(cs.SCHED_TILES) for pan in pans if pan[j][0] == k]
             for k in ("z3", "z2")}
    z3, z2 = idx["z3"], idx["z2"]
    q3 = np.stack([z3._loose_bounds(parse_ecql(q))[1] for q in tiles["z3"][:max(QS)]])
    split = np.empty((len(q3), 8), np.uint32)  # each bt range in two: the same rows
    mid = (q3[:, 4].astype(np.int64) + q3[:, 5]) // 2
    split[:, :4] = q3[:, :4]
    split[:, 4], split[:, 5], split[:, 6], split[:, 7] = q3[:, 4], mid, mid + 1, q3[:, 5]
    q2 = np.stack([z2._loose_bounds(parse_ecql(q))[1] for q in tiles["z2"][:max(QS)]])
    p3 = tuple(z3._cols[c] for c in ("__znx", "__zny", "__zbt"))
    p2 = tuple(z2._cols[c] for c in ("__znx", "__zny"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 19)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    rows = {}
    for nq in QS:
        for kind, r, qmat, planes in (("z3 R=1", 1, q3[:nq], p3), ("z3 R=2", 2, split[:nq], p3),
                                      ("z2", 0, q2[:nq], p2)):
            for valid in (None, half):
                want = zscan.batched_dim_mask_rt(r)(*planes, qmat, valid=valid)
                for want_mask in (False, True):
                    op = "mask" if want_mask else "count"
                    case = f"{kind} {op} Q={nq}" + ("" if valid is None else ", 50% live")
                    call = zscan.batched_dimscan_mask if want_mask else zscan.batched_dimscan_count
                    ref = want if want_mask else want.sum(dim=1, dtype=torch.int32)
                    if not torch.equal(call(qmat, *planes, valid=valid), ref):
                        raise AssertionError(f"{case}: the call != the plain version")
                    iters = 20 if nq == 64 else 50
                    row = {"call_ms": _events(lambda: call(qmat, *planes, valid=valid), iters)}
                    if packed:
                        pk = zscan.batched_dimscan(qmat)
                        pk.device_table(dev, want_mask)
                        launch = lambda pk=pk: pk.run(planes, want_mask, valid=valid)  # noqa: E731
                        if not torch.equal(launch(), ref):
                            raise AssertionError(f"{case}: the launch != the plain version")
                        row["launch_ms"] = _events(launch, iters)
                        row["pack_ms"] = _host(
                            lambda: zscan.batched_dimscan(qmat).device_table(dev, want_mask))
                        row["depths"] = list(pk.depths)
                    rows[case] = row
                    print(f"  {case}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                                    for k, v in row.items()) + f" [{card}]", flush=True)
                del want
                torch.cuda.empty_cache()
    out = {"dimscan_batched_probe": rows, "tree": str(Path(zscan.__file__).resolve()), "card": card}
    if packed and not args.calls_only:
        out["ab"] = _ab(zscan, (("z3 R=1", 1, q3, p3), ("z3 R=2", 2, split, p3), ("z2", 0, q2, p2)), card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
