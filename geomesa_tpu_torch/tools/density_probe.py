"""Where a counted density pass spends its time, stage by stage.

    python -m geomesa_tpu_torch.tools.density_probe

Builds ``density_probe.cu`` (which includes ``csrc/density.cu``) with the
kernels' flags and times each stage of the row loop at 2^26 rows on a
128x128 world grid, every row masked in, on three data sets: uniform
points, GDELT-shaped clustered points (90% in 64 clusters of sigma 0.2
degrees) in random order, and the same clustered points sorted by cell,
as a store that orders rows by key holds them. Stages: 0 loads, 1 + the
float64 pixel math, 2 + ``__match_any_sync``, 3 + a shared atomic per match
group, 4 + a shared atomic per row, 5 + a shared atomic per run of equal
cells (the kernel's merge). Stages 3-5 are checked against the plain
density version. Times are CUDA events over 20 launches after 3 warm-up
launches; the card's name and power limit are printed beside them. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

STAGES = ("loads", "+ pixel math", "+ match_any", "+ match_any merge, shared atomics",
          "+ shared atomic per row", "+ run merge, shared atomics")
WORLD = (-180.0, -90.0, 180.0, 90.0)
N_ROWS = 1 << 26


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _build() -> ctypes.CDLL:
    from geomesa_tpu_torch.kernels import _build as kb

    src = Path(__file__).with_suffix(".cu")
    out = kb.BUILD_DIR / "libdensity_probe.so"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.gm_density_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_double] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.gm_density_probe.restype = ctypes.c_int
    return lib


def _data(dev, n: int, seed: int = 1) -> dict:
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def unif(k, lo, hi):
        return torch.rand(k, generator=g, device=dev, dtype=torch.float64) * (hi - lo) + lo

    cx, cy = unif(64, -170, 170), unif(64, -60, 70)
    cid = torch.randint(0, 64, (n,), generator=g, device=dev)
    x = cx[cid] + torch.randn(n, generator=g, device=dev, dtype=torch.float64) * 0.2
    y = cy[cid] + torch.randn(n, generator=g, device=dev, dtype=torch.float64) * 0.2
    spread = torch.rand(n, generator=g, device=dev) >= 0.9
    k = int(spread.sum())
    x[spread], y[spread] = unif(k, -180, 180), unif(k, -90, 90)
    xc, yc = x.clamp(-180, 180).float(), y.clamp(-90, 90).float()
    order = torch.argsort(torch.floor((yc.double() + 90) * 128 / 180) * 128
                          + torch.floor((xc.double() + 180) * 128 / 360))
    return {
        "uniform": (unif(n, -180, 180).float(), unif(n, -90, 90).float()),
        "clustered": (xc, yc),
        "clustered, sorted by cell": (xc[order].contiguous(), yc[order].contiguous()),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("density_probe: no CUDA device", file=sys.stderr)
        return 2
    from geomesa_tpu_torch.ops.density import density_plain, viewport

    dev = torch.device("cuda:0")
    card = _card()
    fn = _build().gm_density_probe
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    view = viewport(WORLD, 128, 128)
    mask = torch.ones(N_ROWS, dtype=torch.bool, device=dev)
    out = torch.zeros(1 + 128 * 128, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bound = 9 * N_ROWS / 3.35e12 * 1e3
    print(f"density probe, 2^26 rows, 128x128, {sms} CTAs of 1024 threads; "
          f"bytes bound {bound:.4f} ms [{card}]")
    for name, (x, y) in _data(dev, N_ROWS).items():
        want = density_plain(x, y, WORLD, 128, 128, mask=mask).to(torch.int32).reshape(-1)
        for stage, what in enumerate(STAGES):
            def run(s=stage):
                rc = fn(s, x.data_ptr(), y.data_ptr(), mask.data_ptr(), N_ROWS, *view, sms,
                        out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"density probe stage {s}: CUDA error {rc}")
            if stage >= 3:
                out.zero_()
                run()
                if not torch.equal(out[1:], want):
                    raise AssertionError(f"density probe stage {stage} on {name}: grid != plain")
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            print(f"  {name}: stage {stage} ({what}): {start.elapsed_time(end) / 20:.4f} ms [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
