"""The scans' time without a validity plane, for one tree against another.

    python -m geomesa_tpu_torch.tools.null_plane_probe

The count and mask kernels take a validity operand, read on a path of
their own that a null plane never takes. This probe times each of them
with no plane, through the wrappers' calls that every tree of the port
has (no ``valid=``), on 2^26 random rows made on the card from a fixed
seed: the dim scan (z3 at R = 2, and z2), the interleaved scan (z3 over 4
week-bin entries, and z2), the filter scan of a bbox+during program, and
the batched dim and interleaved scans at Q = 64 (query vectors and bounds
from ``chip_smoke.py``'s generators; the interleaved group packed and its
table on the card before the timed loop). CUDA events over 50 launches
(20 at Q = 64), after 3 warm ones; each answer first checked against the
plain version. Run it by path with ``PYTHONPATH`` at each tree's root to
time two trees on one card in turns (parent, change, change, parent).
Prints one JSON line of {case: ms} and the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np

N = 1 << 26
SEED = 20200101


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _chip_smoke():
    """``chip_smoke.py`` beside the imported package (importing runs nothing)."""
    import geomesa_tpu_torch

    path = Path(geomesa_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_null_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    import torch

    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.kernels import _build
    from geomesa_tpu_torch.ops import filter_scan, zscan

    cs = _chip_smoke()
    _build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def u32(hi=None):
        if hi is None:
            return torch.randint(-(1 << 31), 1 << 31, (N,), generator=gen, device=dev,
                                 dtype=torch.int32).view(torch.uint32)
        return torch.randint(0, hi, (N,), generator=gen, device=dev).to(torch.int32).view(torch.uint32)

    maxi, span = (1 << 21) - 1, 12 << 21
    nx, ny, bt, hi, lo = u32(maxi + 1), u32(maxi + 1), u32(span), u32(), u32()
    bins = torch.randint(2600, 2616, (N,), generator=gen, device=dev, dtype=torch.int32)
    q3, q2 = cs.batch_qmat(rng, 1, 2, span)[0], cs.batch_qmat(rng, 1, 0, span)[0]
    bounds = np.stack([zscan.z3_dim_bounds(tuple(a), tuple(b)) for a, b in (
        np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0) for _ in range(4))])
    ids = (2600 + rng.permutation(16)[:4]).astype(np.int32)
    c3, m3 = zscan.build_z3_pallas_scan(bounds, ids)
    a, b = np.sort(rng.integers(0, 1 << 31, (2, 2)), axis=0)
    b2 = zscan.z2_dim_bounds(tuple(a), tuple(b))
    c2, m2 = zscan.build_z2_zscan(b2)
    prog = compile_filter(parse_ecql(
        "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z"),
        SimpleFeatureType.create("g", cs.GDELT_SPEC)).program
    dtg = torch.randint(cs.T0, cs.T0 + 60 * cs.DAY, (N,), generator=gen, device=dev)
    fcols = {"geom__x": torch.rand(N, generator=gen, device=dev) * 360 - 180,
             "geom__y": torch.rand(N, generator=gen, device=dev) * 180 - 90,
             "dtg__hi": (dtg >> 32).to(torch.int32),
             "dtg__lo": (dtg & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)}
    fcols = {c: fcols[c] for c in prog.cols}
    del dtg
    qm3, qm2 = cs.batch_qmat(rng, 64, 1, span), cs.batch_qmat(rng, 64, 0, span)
    zb, zi = cs.batch_zbounds(rng, 64, 16)
    pk = zscan.batched_zscan(zb, zi)
    zb2 = np.stack([zscan.z2_dim_bounds(tuple(x), tuple(y)) for x, y in (
        np.sort(rng.integers(0, 1 << 31, (2, 2)), axis=0) for _ in range(64))])
    pk2 = zscan.batched_zscan(zb2, None)
    cases = {
        "dimscan_z3_count": (lambda: zscan.dimscan_count(q3, nx, ny, bt),
                             lambda: zscan.dimscan_plain(q3, nx, ny, bt).sum(dtype=torch.int32), 50),
        "dimscan_z3_mask": (lambda: zscan.dimscan_mask(q3, nx, ny, bt),
                            lambda: zscan.dimscan_plain(q3, nx, ny, bt), 50),
        "dimscan_z2_count": (lambda: zscan.dimscan_count(q2, nx, ny),
                             lambda: zscan.dimscan_plain(q2, nx, ny).sum(dtype=torch.int32), 50),
        "zscan_z3_count": (lambda: c3(bins, hi, lo),
                           lambda: zscan.z3_zscan_mask(hi, lo, bins, bounds, ids).sum(dtype=torch.int32), 50),
        "zscan_z3_mask": (lambda: m3(bins, hi, lo),
                          lambda: zscan.z3_zscan_mask(hi, lo, bins, bounds, ids), 50),
        "zscan_z2_count": (lambda: c2(hi, lo),
                           lambda: zscan.z2_zscan_mask(hi, lo, b2).sum(dtype=torch.int32), 50),
        "filter_scan_count": (lambda: filter_scan.filter_scan_count(prog, fcols),
                              lambda: filter_scan.run_program_plain(prog, fcols).sum(dtype=torch.int32), 50),
        "filter_scan_mask": (lambda: filter_scan.filter_scan_mask(prog, fcols),
                             lambda: filter_scan.run_program_plain(prog, fcols), 50),
        "dimscan_batched_z3_count Q=64": (
            lambda: zscan.batched_dimscan_count(qm3, nx, ny, bt),
            lambda: zscan.batched_dim_mask_rt(1)(nx, ny, bt, qm3).sum(dim=1, dtype=torch.int32), 20),
        "dimscan_batched_z2_count Q=64": (
            lambda: zscan.batched_dimscan_count(qm2, nx, ny),
            lambda: zscan.batched_dim_mask_rt(0)(nx, ny, qm2).sum(dim=1, dtype=torch.int32), 20),
        "zscan_batched_z3_count Q=64": (
            lambda: pk.run(bins, hi, lo, want_mask=False),
            lambda: zscan.batched_kind_mask("z3")(hi, lo, bins, zb, zi).sum(dim=1, dtype=torch.int32), 20),
        "zscan_batched_z2_count Q=64": (
            lambda: pk2.run(None, hi, lo, want_mask=False),
            lambda: zscan.batched_kind_mask("z2")(hi, lo, zb2).sum(dim=1, dtype=torch.int32), 20),
    }
    pk.device_table(dev)
    pk2.device_table(dev)
    out = {}
    for name, (kern, plain, iters) in cases.items():
        if not torch.equal(kern(), plain()):
            raise AssertionError(f"{name}: kernel != plain version")
        out[name] = cs.time_ms(kern, iters)
    print(json.dumps({"null_plane_ms": out, "card": _card()}), flush=True)


if __name__ == "__main__":
    main()
