"""Where a call of the Q-batched interleaved scan spends its time.

    python -m geomesa_tpu_torch.tools.zscan_batched_probe

Stages ``chip_smoke.py``'s 2^26 GDELT-shaped rows (its phase 3 generator,
seed and schemas) as phase 3c does: the week-binned interleaved z3 index
and its date-less z2 sibling (``dim_planes=False``). Groups are phase 3f's
map-client tiles, one tile of each pan in turn, as phase 4 takes them. At
Q in {1, 4, 8, 64}, z3 and z2, count and mask, it times:

1. the call as phase 4 times it (``batched_zscan_count`` / ``_mask`` on
   the group's stacked bounds: packing, upload, launch), CUDA events over
   back-to-back calls;
2. the launch alone: the group packed and its table on the card before the
   timed loop, CUDA events;
3. the host's packing and upload alone: the host clock around packing, the
   upload and a synchronise, median of 20.

Then, at Q from 1 to 8, the packer's choices one against another:
the launch alone with each way forced (z3: every row testing every record
or each row its bin's, cell boxes compact or masked; z2: compact or
masked); ``--calls-only`` leaves this part out.

Every answer is checked against the package's plain version first. The
probe runs against the package it imports, so that two trees can be
timed on one card in turns (``PYTHONPATH`` at each tree's root, the probe
run by its path); a package that does not pack groups
(``batched_zscan``) gets the call alone. The card's name and power limit
are printed beside the numbers. Needs a CUDA device and nvcc; about a
minute of staging.
"""

from __future__ import annotations

import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

QS = (1, 4, 8, 64)
AB_QS = (1, 2, 3, 4, 5, 6, 7, 8)


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


def _ab(zscan, lb3, lb2, p3, p2, card: str) -> None:
    """The packer's choices at small Q, each way forced through its
    thresholds (``FLAT_MAX_RECORDS``, ``MASKED_MAX_MEET``): z3 flat or
    binned, compact or masked cell boxes; z2 compact or masked; the launch
    alone, count and mask, each checked against the plain version."""
    import torch

    big = 1 << 30
    saved = zscan.FLAT_MAX_RECORDS, zscan.MASKED_MAX_MEET
    try:
        for nq in AB_QS:
            b3, i3 = _stacked(lb3[:nq])
            b2 = np.stack([lb[1] for lb in lb2[:nq]])
            for kind, bounds, ids, planes, finds in (("z3", b3, i3, p3, ("flat", "binned")),
                                                     ("z2", b2, None, p2, ("flat",))):
                bins, hi, lo = planes
                want = zscan.batched_kind_mask(kind)(
                    *((hi, lo, bins, bounds, ids) if kind == "z3" else (hi, lo, bounds)))
                # the most records a row can meet
                meet = nq if ids is None else np.unique(ids[ids >= 0], return_counts=True)[1].max()
                for find in finds:
                    for form in ("compact", "masked"):
                        zscan.FLAT_MAX_RECORDS = big if find == "flat" else 0
                        zscan.MASKED_MAX_MEET = big if form == "masked" else 0
                        pk = zscan.batched_zscan(bounds, ids)
                        pk.device_table(hi.device)
                        shape = [(lc.nc, lc.nm, lc.binned) for lc in pk.launches]
                        ms = []
                        for want_mask in (False, True):
                            got = pk.run(bins, hi, lo, want_mask=want_mask)
                            ref = want if want_mask else want.sum(dim=1, dtype=torch.int32)
                            if not torch.equal(got, ref):
                                raise AssertionError(f"{kind} {find} {form} Q={nq}: != the plain version")
                            ms.append(_events(lambda m=want_mask: pk.run(bins, hi, lo, want_mask=m), 50))
                        print(f"  A/B {kind} Q={nq} meet={meet} {find} {form} (compact, masked, binned per launch "
                              f"{shape}): launch alone count {ms[0]:.4f} ms, mask {ms[1]:.4f} ms [{card}]",
                              flush=True)
                del want
                torch.cuda.empty_cache()
    finally:
        zscan.FLAT_MAX_RECORDS, zscan.MASKED_MAX_MEET = saved


def _stacked(lbs):
    """A group's z3 loose bounds stacked as ``batched_zscan_count`` takes
    them: (Q, B, 3, 6) bounds, (Q, B) ids, -1 for padding."""
    bmax = max(len(lb[2]) for lb in lbs)
    b3 = np.zeros((len(lbs), bmax, 3, 6), np.uint32)
    i3 = np.full((len(lbs), bmax), -1, np.int32)
    for i, lb in enumerate(lbs):
        b3[i, : len(lb[2])], i3[i, : len(lb[2])] = lb[1], lb[2]
    return b3, i3


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="time the batched interleaved scan's calls")
    ap.add_argument("--calls-only", action="store_true", help="leave out the packer's A/B")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zscan_batched_probe: no CUDA device", file=sys.stderr)
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
    packed = hasattr(zscan, "batched_zscan")  # else: the call alone
    _build.build_all()
    t = time.time()
    cols = cs.make_columns(cs.N_ROWS, cs.SEED)
    idx = {}
    for key, spec, names in (("z3", cs.GDELT_SPEC, ("count", "dtg", "geom")),
                             ("z2", cs.Z2_SPEC, ("count", "geom"))):
        batch = FeatureBatch.from_columns(SimpleFeatureType.create("t", spec),
                                          {k: cols[k] for k in names})
        idx[key] = DeviceIndex(BatchStore(batch), "t", z_planes=True, dim_planes=False, device=dev)
    torch.cuda.synchronize()
    n = len(idx["z3"])
    print(f"zscan batched probe ({zscan.__file__}): {n:,} rows staged in "
          f"{time.time() - t:.1f} s [{card}]", flush=True)
    pans, _ = cs.sched_traffic(cols["_centers"])
    tiles = [pan[j][1] for j in range(cs.SCHED_TILES) for pan in pans if pan[j][0] == "z3i"]
    z3, z2 = idx["z3"], idx["z2"]
    lb3 = [z3._loose_bounds(parse_ecql(q)) for q in tiles[:max(QS)]]
    lb2 = [z2._loose_bounds(parse_ecql(q.split(" AND ")[0])) for q in tiles[:max(QS)]]
    p3 = (z3._cols["__zbin"], z3._cols["__zhi"], z3._cols["__zlo"])
    p2 = (None, z2._cols["__zhi"], z2._cols["__zlo"])
    for nq in QS:
        b3, i3 = _stacked(lb3[:nq])
        b2 = np.stack([lb[1] for lb in lb2[:nq]])
        for kind, bounds, ids, planes in (("z3", b3, i3, p3), ("z2", b2, None, p2)):
            bins, hi, lo = planes
            want = zscan.batched_kind_mask(kind)(
                *((hi, lo, bins, bounds, ids) if kind == "z3" else (hi, lo, bounds)))
            for want_mask in (False, True):
                op = "mask" if want_mask else "count"
                call = zscan.batched_zscan_mask if want_mask else zscan.batched_zscan_count
                ref = want if want_mask else want.sum(dim=1, dtype=torch.int32)
                got = call(bounds, ids, hi, lo, bins=bins)
                if not torch.equal(got, ref):
                    raise AssertionError(f"{kind} {op} Q={nq}: the call != the plain version")
                iters = 20 if nq == 64 else 50
                call_ms = _events(lambda: call(bounds, ids, hi, lo, bins=bins), iters)
                line = f"  {kind} {op} Q={nq}: call {call_ms:.4f} ms"
                if packed:
                    pk = zscan.batched_zscan(bounds, ids)
                    pk.device_table(dev)
                    launch = lambda pk=pk: pk.run(bins, hi, lo, want_mask=want_mask)  # noqa: E731
                    if not torch.equal(launch(), ref):
                        raise AssertionError(f"{kind} {op} Q={nq}: the launch != the plain version")
                    host_ms = _host(lambda: zscan.batched_zscan(bounds, ids).device_table(dev))
                    line += (f", launch alone {_events(launch, iters):.4f} ms, packing and upload "
                             f"alone {host_ms:.4f} ms")
                print(f"{line} [{card}]", flush=True)
                del got
            del want
            torch.cuda.empty_cache()
    if packed and not args.calls_only:
        _ab(zscan, lb3, lb2, p3, p2, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
