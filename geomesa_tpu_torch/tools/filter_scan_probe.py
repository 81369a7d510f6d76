"""The filter scan's rows, and its wrapper's host time per call, for one
tree against another.

    python -m geomesa_tpu_torch.tools.filter_scan_probe

Times ``gm_filter_scan`` through the wrappers' calls that every tree of the
port has (``filter_scan_count`` / ``filter_scan_mask``) at the shapes of
``chip_smoke.py``'s phase 4, on random rows made on the card from a fixed
seed: the bbox+during program over 2^26 point rows (count and mask, and
with a validity plane half live), BBOX and BBOX AND DURING over 2^26
envelope rows, the same bbox+during program over the first 2^20 and 2^23
rows (a store run: one partition, eight merged), the one-compare program
``count > 500`` over 2^23 rows beside the one PyTorch call that computes
it, and a 64-edge polygon INTERSECTS over 2^26 points (bound by its
operations). For each: CUDA events over 50 launches after 3 warm ones
(``ms``), and the host clock over 50 calls enqueued back to back with no
synchronise inside (``host_ms``); for the one-compare program also the
kernel's and the library call's times with the L2 cache flushed before
each call (``ms_l2_flushed``, ``library_ms_l2_flushed``: a 128 MB buffer
overwritten, an event pair around each call). Each answer is first
checked against the plain version. Run it by path with ``PYTHONPATH`` at each tree's root to
time two trees on one card in turns (parent, change, change, parent).
Prints one JSON line of {case: {"ms", "host_ms"}} and the card's name and
power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

N = 1 << 26
SEED = 20200101
T0 = 1_577_836_800_000  # 2020-01-01
DAY = 86_400_000
POINTS = "count:Int,dtg:Date,*geom:Point:srid=4326"
FOOTPRINTS = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"
BBOX_DURING = ("BBOX(geom, -10, 35, 30, 60) AND "
               "dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ring(k, cx=10.0, cy=45.0, r=12.0) -> str:
    a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    pts = [(cx + r * np.cos(t) * (1.0 + 0.3 * (i % 3)), cy + r * np.sin(t))
           for i, t in enumerate(a)]
    pts.append(pts[0])
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def time_ms(fn, iters: int = 50, warm: int = 3, flush_l2: bool = False) -> float:
    """CUDA events over ``iters`` calls after ``warm`` ones; with
    ``flush_l2``, a buffer larger than the L2 cache is overwritten before
    each call and an event pair around each call times the calls alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if flush_l2:
        buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=torch.cuda.current_device())
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for i, (start, end) in enumerate(marks):
            buf.fill_(i)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in marks) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def main() -> None:
    import torch

    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.kernels import _build
    from geomesa_tpu_torch.ops import filter_scan

    _build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(lo, hi):
        return (torch.rand(N, generator=gen, device=dev, dtype=torch.float64)
                * (hi - lo) + lo).to(torch.float32)

    dtg = torch.randint(T0, T0 + 60 * DAY, (N,), generator=gen, device=dev)
    x0, y0 = rand(-180.0, 180.0), rand(-56.0, 72.0)
    planes = {
        "geom__x": rand(-180.0, 180.0), "geom__y": rand(-90.0, 90.0),
        "count": torch.randint(0, 1000, (N,), generator=gen, device=dev, dtype=torch.int32),
        "dtg__hi": (dtg >> 32).to(torch.int32),
        "dtg__lo": (dtg & 0xFFFFFFFF).to(torch.int32).view(torch.uint32),
        "geom__x0": x0, "geom__y0": y0,
        "geom__x1": x0 + rand(5e-5, 6e-4), "geom__y1": y0 + rand(5e-5, 6e-4),
    }
    del dtg
    half = torch.rand(N, generator=gen, device=dev) < 0.5
    pts, env = SimpleFeatureType.create("g", POINTS), SimpleFeatureType.create("o", FOOTPRINTS)

    def prog(ecql, sft):
        return compile_filter(parse_ecql(ecql), sft).program

    bd = prog(BBOX_DURING, pts)
    cases = [  # (case, program, rows, validity plane, library call)
        ("bbox+during 2^26", bd, N, None, None),
        ("bbox+during 2^26, validity plane 50% live", bd, N, half, None),
        ("envelope BBOX 2^26", prog("BBOX(geom, -10, 35, 30, 60)", env), N, None, None),
        ("envelope BBOX AND DURING 2^26", prog(BBOX_DURING, env), N, None, None),
        ("store run 2^20, bbox+during", bd, 1 << 20, None, None),
        ("store run 2^23, bbox+during", bd, 1 << 23, None, None),
        ("store run 2^23, count > 500", prog("count > 500", pts), 1 << 23, None,
         lambda cols: torch.gt(cols["count"], 500)),
        ("64-edge polygon INTERSECTS 2^26", prog(f"INTERSECTS(geom, POLYGON(({_ring(64)})))", pts),
         N, None, None),
    ]
    out = {}
    for case, p, n, valid, library in cases:
        cols = {c: planes[c][:n] for c in p.cols}
        for kind in ("count", "mask"):
            if kind == "count":
                kern = lambda p=p, cols=cols, v=valid: filter_scan.filter_scan_count(p, cols, valid=v)  # noqa: E731
                plain = lambda p=p, cols=cols, v=valid: filter_scan.run_program_plain(  # noqa: E731
                    p, cols, valid=v).sum(dtype=torch.int32)
            else:
                kern = lambda p=p, cols=cols, v=valid: filter_scan.filter_scan_mask(p, cols, valid=v)  # noqa: E731
                plain = lambda p=p, cols=cols, v=valid: filter_scan.run_program_plain(p, cols, valid=v)  # noqa: E731
            if not torch.equal(kern().reshape(-1), plain().reshape(-1)):
                raise AssertionError(f"{case} {kind}: kernel != plain version")
            row = {"ms": time_ms(kern), "host_ms": host_ms(kern)}
            if library is not None:
                row["ms_l2_flushed"] = time_ms(kern, flush_l2=True)
            if library is not None and kind == "mask":
                lib = lambda cols=cols, f=library: f(cols)  # noqa: E731
                if not torch.equal(lib(), kern()):
                    raise AssertionError(f"{case}: the library call != the kernel")
                row["library_ms"] = time_ms(lib)
                row["library_ms_l2_flushed"] = time_ms(lib, flush_l2=True)
            out[f"{case} {kind}"] = row
    print(json.dumps({"filter_scan_probe": out, "card": _card()}), flush=True)


if __name__ == "__main__":
    main()
