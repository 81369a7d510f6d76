#!/usr/bin/env python3
"""Drive geomesa_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at ragged
     sizes with edge rows (dim scans at R in {1,2,4,8} and z2; the baked dim
     scan with 0 to 16 bt ranges; the interleaved scan at n in {0, 1, 1000,
     2^20+17} with 1 to 64 bin entries, padded and all-padded, and its z2
     variant; the filter scan over a fixed filter list; the density kernel
     at n in {0, 1, 1000, 2^20+17} on six grids from 16x16 to 2048x1024,
     clustered and uniform points, with and without a mask): bit-exact,
     weighted density grids within rtol 1e-6;
  3. the main path at full size: a GDELT-shaped resident Z3 point type
     (count:Int,dtg:Date,*geom:Point, 2^26 rows from a fixed seed: 90% of
     points in 64 city clusters, coordinates float32, dtg over 60 days from
     2020-01-01) and its date-less Z2 sibling, staged through
     DeviceIndex(BatchStore(batch)) and queried with 32 bbox+during
     filters through count(loose=True), count(loose=False), query() and
     query(loose=True), each Z3 window also through the baked dim scan
     against the runtime one; then 9 density calls (INCLUDE over the world at
     512x256 and 128x128, the Europe 5-day query exact, loose and weighted,
     a city viewport, grids up to 2048x1024, one on Z2) and 4 Count/MinMax/Histogram stats calls;
     every answer is checked on the host with numpy, and the launch counts
     of each drive show which kernels carried it;
  3c. (run before 3b, while the main path's answers are held) the
     interleaved key layout on the same rows: the Z3 and Z2 indexes
     staged with dim_planes=False (every loose count, mask and fid set equal
     to the dim-plane index's; loose density and stats), then the same
     points with dtg over 2015-02-18 .. 2024-12-31 in day bins, which the
     staging must put in the interleaved layout by itself (windows of 1 day
     to 8 weeks on the interleaved scan, longer ones on the filter scan;
     loose answers against numpy over host-encoded keys on a subsample,
     exact counts against numpy);
  3b. a labeled Z3 index of 2^24 rows (labels from a fixed seed over six
     visibility expressions): counts, fid sets, density grids and a
     Count() stat under three auth sets, checked against numpy with a
     per-label verdict table;
  4. each kernel's time at the main path's shapes (CUDA events) beside its
     bound, its plain version's time and, for density, torch.bincount;
     the interleaved scan also at 28 day bins; the density kernel's
     shared-memory and global engines on a counted 128x128 grid.

Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20200101
N_ROWS = 1 << 26
T0 = 1_577_836_800_000  # 2020-01-01T00:00:00Z
DAY = 86_400_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Operations bounds. The scans are 32-bit integer and compare work, which
# Hopper issues at 64 lanes per SM per clock: 132 SMs x 64 x 1.98 GHz. The
# density kernel's float64 pixel math (separate multiplies and subtracts,
# no FMA) runs at the same 64 lanes per SM per clock; the data sheet's
# 67 TFLOP/s float32 and 34 TFLOP/s float64 count an FMA as two.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
GDELT_SPEC = "count:Int,dtg:Date,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,*geom:Point:srid=4326"


CARD = ""  # "name, power limit" from nvidia-smi, set in main(); beside every time


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against plain versions ----------------------------------


class Errs:
    """max |kernel - plain| per kernel over every comparison made."""

    def __init__(self):
        self.err: dict = {}

    def check(self, name, got, want, what):
        import torch

        g = got.to(torch.int64).cpu()
        w = want.to(torch.int64).cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = int((g - w).abs().max()) if g.numel() else 0
        self.err[name] = max(self.err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {err})")

    def check_grid(self, name, got, want, rtol, what):
        """Float grids: equal when ``rtol`` is 0, else |got - want| <=
        rtol * |want| cell by cell."""
        import torch

        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.err[name] = max(self.err.get(name, 0.0), err)
        ok = torch.equal(got, want) if rtol == 0 else bool(
            (diff <= rtol * want.to(torch.float64).abs()).all())
        if not ok:
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {err})")


def check_dimscans(dev, errs: Errs):
    import torch

    from geomesa_tpu_torch.ops import zscan

    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    for n in (1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + n)
        nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
        ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
        bt = rng.integers(0, 12 << 21, n).astype(np.uint32)
        edge = min(n, 4)
        bt[:edge] = sent  # out-of-window sentinel rows never match
        nx[-edge:] = maxi  # rows at max_index
        ny[-edge:] = maxi
        planes = [torch.from_numpy(a).to(dev) for a in (nx, ny, bt)]
        for r in (0, 1, 2, 4, 8):
            q = np.empty(4 + 2 * r, np.uint32)
            q[:4] = [0, maxi, rng.integers(0, maxi), maxi]  # bounds at max_index
            for k in range(r):
                a, b = np.sort(rng.integers(0, 12 << 21, 2))
                q[4 + 2 * k: 6 + 2 * k] = (sent, 0) if k % 2 else (a, b)  # inverted pads
            ps = planes[:2] if r == 0 else planes
            z = "z2" if r == 0 else "z3"
            want = zscan.dimscan_plain(q, *ps)
            errs.check(f"dimscan_{z}_mask", zscan.dimscan_mask(q, *ps), want, f"n={n} R={r}")
            errs.check(
                f"dimscan_{z}_count", zscan.dimscan_count(q, *ps).reshape(1),
                want.sum(dtype=torch.int32).reshape(1), f"n={n} R={r}",
            )
    torch.cuda.synchronize()


def check_baked_dimscans(dev, errs: Errs):
    """The baked dim scan against its plain version: 0 to 16 bt ranges,
    inverted ranges among them, sentinel rows and rows at max_index."""
    import torch

    from geomesa_tpu_torch.ops import zscan

    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    for n in (0, 1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + 7 * n)
        nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
        ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
        bt = rng.integers(0, 40 << 21, n).astype(np.uint32)
        edge = min(n, 4)
        bt[:edge] = sent
        nx[-edge:] = maxi
        planes = [torch.from_numpy(a).to(dev) for a in (nx, ny, bt)]
        for r in (0, 1, 2, 3, 8, 16):
            qnx = tuple(int(v) for v in np.sort(rng.integers(0, maxi + 1, 2)))
            qny = (int(rng.integers(0, maxi)), maxi)
            ranges = [tuple(int(v) for v in np.sort(rng.integers(0, 40 << 21, 2)))
                      for _ in range(r)]
            if r > 2:
                ranges[2] = (sent, 0)  # inverted: never matches
            count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
            want = zscan.z3_dimscan_mask(*planes, qnx, qny, ranges)
            errs.check("dimscan_baked_mask", mask_fn(*planes), want, f"n={n} ranges={r}")
            errs.check("dimscan_baked_count", count_fn(*planes).reshape(1),
                       want.sum(dtype=torch.int32).reshape(1), f"n={n} ranges={r}")
    torch.cuda.synchronize()


def check_zscans(dev, errs: Errs):
    """The interleaved scan against its plain version: keys of random
    points over 64 week bins (a few rows in bin -1), 1 to 64 bin entries
    from the curve's own cell bounds or random words, some ids padded,
    and every query once more all-padded (counts 0); the z2 variant on
    the same points."""
    import torch

    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.curves.zorder import u64_hi_lo
    from geomesa_tpu_torch.ops import zscan

    maxi = (1 << 21) - 1
    for n in (0, 1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + 3 * n)
        x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
        off = rng.uniform(0, 604_800, n)
        k = min(n, 3)
        x[:k], y[:k], off[:k] = 180.0, 90.0, 604_800.0  # max_index corners
        bins = (2600 + rng.integers(0, 64, n)).astype(np.int32)
        bins[n - k:] = -1
        h3, l3 = u64_hi_lo(Z3SFC().index(x, y, off))
        h2, l2 = u64_hi_lo(Z2SFC().index(x, y))
        p3 = [torch.from_numpy(a).to(dev) for a in (bins, h3, l3)]
        p2 = [torch.from_numpy(a).to(dev) for a in (h2, l2)]
        for b in (1, 2, 5, 28, 64):
            for random_words in (False, True):
                if random_words:
                    bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
                else:
                    bounds = np.stack([zscan.z3_dim_bounds(tuple(lo), tuple(hi)) for lo, hi in (
                        np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0) for _ in range(b))])
                ids = (2600 + rng.permutation(64)[:b]).astype(np.int32)
                ids[rng.random(b) < 0.25] = -1
                for ii in (ids, np.full(b, -1, np.int32)):
                    what = f"n={n} B={b} {'random' if random_words else 'cells'}"
                    count_fn, mask_fn = zscan.build_z3_pallas_scan(bounds, ii)
                    want = zscan.z3_zscan_mask(p3[1], p3[2], p3[0], bounds, ii)
                    errs.check("zscan_z3_mask", mask_fn(*p3), want, what)
                    got_c = count_fn(*p3)
                    errs.check("zscan_z3_count", got_c.reshape(1),
                               want.sum(dtype=torch.int32).reshape(1), what)
                    if (ii < 0).all() and int(got_c):
                        raise AssertionError(f"zscan_z3_count {what}: all-padded query counted rows")
        for random_words in (False, True):
            if random_words:
                bounds = rng.integers(0, 1 << 32, (2, 6), dtype=np.uint64).astype(np.uint32)
            else:
                lo, hi = np.sort(rng.integers(0, (1 << 31), (2, 2)), axis=0)
                bounds = zscan.z2_dim_bounds(tuple(lo), tuple(hi))
            count_fn, mask_fn = zscan.build_z2_zscan(bounds)
            want = zscan.z2_zscan_mask(*p2, bounds)
            errs.check("zscan_z2_mask", mask_fn(*p2), want, f"n={n}")
            errs.check("zscan_z2_count", count_fn(*p2).reshape(1),
                       want.sum(dtype=torch.int32).reshape(1), f"n={n}")
    torch.cuda.synchronize()


def _ring(k, cx=10.0, cy=45.0, r=12.0):
    a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    pts = [(cx + r * np.cos(t) * (1.0 + 0.3 * (i % 3)), cy + r * np.sin(t))
           for i, t in enumerate(a)]
    pts.append(pts[0])
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


W32 = 1 << 32
SCAN_FILTERS = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "DWITHIN(geom, POINT(5 45), 500, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    "DISJOINT(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    f"INTERSECTS(geom, POLYGON(({_ring(64)})))",
    f"DISJOINT(geom, POLYGON(({_ring(64)})))",
    "count > 500 AND count <= 900.5",
    "count IN (1, 2, 3, 42, 999)",
    "NOT (count < 200 OR BBOX(geom, 0, 0, 90, 45)) OR dtg > '2020-02-20T00:00:00Z'",
    f"dtg BETWEEN {W32 - 1} AND {2 * W32}",
]


def check_filter_scans(dev, errs: Errs):
    import torch

    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan
    from geomesa_tpu_torch.ops.scan import stage_columns

    sft = SimpleFeatureType.create("gdelt", GDELT_SPEC)
    for n in (1, 1000, (1 << 20) + 17):
        cols = make_columns(n, SEED + n)
        dtg = cols["dtg"]
        k = min(n, 6)
        dtg[:k] = [W32 - 1, W32, W32 + 1, 2 * W32, -W32, -1][:k]  # i64 word edges
        batch = FeatureBatch.from_columns(sft, cols)
        for ecql in SCAN_FILTERS:
            cf = compile_filter(parse_ecql(ecql), sft)
            if cf.program is None:
                raise AssertionError(f"the filter-scan kernel refused {ecql}")
            staged = stage_columns(batch, cf.device_cols, dev)
            want = filter_scan.run_program_plain(cf.program, staged)
            errs.check("filter_scan_mask", cf.mask(staged), want, f"n={n} {ecql[:40]}")
            errs.check(
                "filter_scan_count", cf.count(staged).reshape(1),
                want.sum(dtype=torch.int32).reshape(1), f"n={n} {ecql[:40]}",
            )
    torch.cuda.synchronize()


DENSITY_ENV = (-60.0, -45.0, 100.0, 60.0)
DENSITY_GRIDS = [(16, 16), (100, 37), (256, 256), (512, 512), (1024, 1024), (2048, 1024)]


def density_case(n, width, height, clustered, seed):
    """float32 points: clustered (8 centres, sigma 0.2 degrees) or uniform
    over a box wider than the viewport; the first rows sit on cell edges,
    on the viewport border and just outside it."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = DENSITY_ENV
    if clustered:
        centres = rng.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (8, 2))
        xy = centres[rng.integers(0, 8, n)] + rng.normal(0.0, 0.2, (n, 2))
    else:
        xy = rng.uniform([x0 - 10, y0 - 10], [x1 + 10, y1 + 10], (n, 2))
    k = min(n, 64)
    xy[:k, 0] = x0 + rng.integers(0, width + 1, k) * (x1 - x0) / width
    xy[:k, 1] = y0 + rng.integers(0, height + 1, k) * (y1 - y0) / height
    if n >= 4:
        xy[:4] = [[x0, y0], [x1, y1], [x0 - 1e-3, 0.0], [0.0, y1 + 1e-3]]
    x = np.ascontiguousarray(xy[:, 0], np.float32)
    y = np.ascontiguousarray(xy[:, 1], np.float32)
    return x, y, rng.random(n) < 0.6, rng.uniform(0.5, 2.0, n).astype(np.float32)


def check_density(dev, errs: Errs):
    import torch

    from geomesa_tpu_torch.ops.density import _launch, density_grid, density_plain

    for n in (0, 1, 1000, (1 << 20) + 17):
        for width, height in DENSITY_GRIDS:
            for clustered in (True, False):
                x, y, m, w = (torch.from_numpy(a).to(dev) for a in
                              density_case(n, width, height, clustered, SEED + n + width))
                for mask in (None, m):
                    what = (f"n={n} {width}x{height} {'clustered' if clustered else 'uniform'}"
                            f"{' masked' if mask is not None else ''}")
                    args = (x, y, DENSITY_ENV, width, height)
                    want = density_plain(*args, mask=mask)
                    want_w = density_plain(*args, mask=mask, weights=w)
                    errs.check_grid("density_count", density_grid(*args, mask=mask), want, 0.0, what)
                    errs.check_grid("density_weighted", density_grid(*args, mask=mask, weights=w),
                                    want_w, 1e-6, what)
                    # the global engine on the counted grids that take shared memory
                    errs.check_grid("density_count", _launch(*args, mask, None, shared=False),
                                    want, 0.0, what + " global engine")
    torch.cuda.synchronize()


# -- phase 3: the main path ---------------------------------------------------


def make_columns(n: int, seed: int) -> dict:
    """GDELT-shaped rows: 90% of points in 64 city clusters (sigma 0.2
    degrees), the rest uniform; float32 coordinates; dtg over 60 days."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-170.0, 170.0, 64)
    cy = rng.uniform(-60.0, 70.0, 64)
    cid = rng.integers(0, 64, n)
    x = cx[cid] + rng.normal(0.0, 0.2, n)
    y = cy[cid] + rng.normal(0.0, 0.2, n)
    uni = rng.random(n) >= 0.9
    x[uni] = rng.uniform(-180.0, 180.0, int(uni.sum()))
    y[uni] = rng.uniform(-90.0, 90.0, int(uni.sum()))
    xy = np.empty((n, 2), np.float64)
    xy[:, 0] = np.clip(x, -180.0, 180.0).astype(np.float32)
    xy[:, 1] = np.clip(y, -90.0, 90.0).astype(np.float32)
    return {
        "count": rng.integers(0, 1000, n).astype(np.int32),
        "dtg": rng.integers(T0, T0 + 60 * DAY, n),
        "geom": xy,
        "_centers": np.stack([cx, cy], axis=1),
    }


def _day(d: float) -> str:
    ms = T0 + int(d * DAY)
    return str(np.datetime64(ms, "ms")) + "Z"


REGIONS = [
    ("europe", (-10, 35, 30, 60)),
    ("north_america", (-130, 20, -60, 55)),
    ("south_america", (-82, -56, -34, 13)),
    ("africa", (-18, -35, 52, 38)),
    ("asia", (60, 5, 150, 55)),
    ("oceania", (110, -48, 180, -10)),
    ("france", (-5, 42, 8, 51)),
    ("japan", (129, 31, 146, 46)),
    ("india", (68, 6, 97, 36)),
    ("usa", (-125, 24, -66, 49)),
    ("brazil", (-74, -34, -34, 5)),
    ("world", (-180, -90, 180, 90)),
]
WINDOWS = [(9, 14), (0, 1), (3.25, 5.5), (6, 13), (20, 34), (27, 55), (40, 41),
           (13.5, 14.5), (1, 29), (50, 59.99)]


def main_queries(centers: np.ndarray) -> list:
    """32 bbox+during filters, city to continent boxes, 1-day to 4-week
    windows; the first is the bench's Europe 5-day query."""
    qs = []
    for i, (_, box) in enumerate(REGIONS):
        w = WINDOWS[i % len(WINDOWS)]
        qs.append((box, w))
    for i in range(20):  # city boxes around cluster centres
        cx, cy = centers[i]
        h = (0.1, 0.25, 0.5, 1.0)[i % 4]
        box = (round(cx - h, 3), round(cy - h, 3), round(cx + h, 3), round(cy + h, 3))
        qs.append((box, WINDOWS[(i + 3) % len(WINDOWS)]))
    return [
        (f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND "
         f"dtg DURING {_day(w[0])}/{_day(w[1])}", b, w)
        for b, w in qs
    ]


def window_ms(w) -> tuple:
    """A window in days from T0 as the (start, end) ms its DURING gives."""
    return T0 + int(w[0] * DAY), T0 + int(w[1] * DAY)


def pct(v, p):
    return float(np.percentile(np.asarray(v) * 1e3, p))


def read_launches(tag: str, calls: dict) -> dict:
    """The launch counts since the last reset_counts(), held against the
    calls the drive made (every other kernel: 0); device_fn must serve
    nothing."""
    from geomesa_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    fallbacks = dict(kernels.DEVICE_FN_CALLS)
    want = {k: calls.get(k, 0) for k in kernels.KERNEL_NAMES}
    log(f"{tag} launches:", json.dumps(launches), "device_fn calls:", json.dumps(fallbacks))
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != the calls made {want}")
    if any(fallbacks.values()):
        raise AssertionError(f"{tag}: device_fn served scans: {fallbacks}")
    return launches


def run_main_path(dev, cols):
    """Stage both indexes, then run every query through the public entry
    points; return timings and the state the checks need."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY, DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.ops import zscan
    from geomesa_tpu_torch.store.direct import BatchStore

    n = len(cols["count"])
    t = time.time()
    sft3 = SimpleFeatureType.create("gdelt", GDELT_SPEC)
    b3 = FeatureBatch.from_columns(sft3, {k: cols[k] for k in ("count", "dtg", "geom")})
    di3 = DeviceIndex(BatchStore(b3), "gdelt", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage3 = time.time() - t
    if not (di3._z_kind == "z3" and Z_BT in di3._cols):
        raise AssertionError("the Z3 index is not in dim-plane mode")
    t = time.time()
    sft2 = SimpleFeatureType.create("points", Z2_SPEC)
    b2 = FeatureBatch.from_columns(sft2, {k: cols[k] for k in ("count", "geom")})
    di2 = DeviceIndex(BatchStore(b2), "points", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage2 = time.time() - t
    if not (di2._z_kind == "z2" and Z_NX in di2._cols and Z_NY in di2._cols):
        raise AssertionError("the Z2 index is not in dim-plane mode")
    log(f"staged {n:,} rows: z3 {stage3:.2f} s ({di3.nbytes / 1e9:.3f} GB resident), "
        f"z2 {stage2:.2f} s ({di2.nbytes / 1e9:.3f} GB resident)")

    queries = main_queries(cols["_centers"])
    z2_queries = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for _, b, _ in queries[:8]]
    lat = {k: [] for k in ("count_loose", "count_exact", "query_exact", "query_loose")}
    res3, res2 = [], []
    planes3 = (di3._cols[Z_NX], di3._cols[Z_NY], di3._cols[Z_BT])
    sfc3 = Z3SFC()
    kernels.reset_counts()
    for ecql, box, w in queries:
        out = {}
        for key, fn in (
            ("count_loose", lambda: di3.count(ecql, loose=True)),
            ("count_exact", lambda: di3.count(ecql, loose=False)),
            ("query_exact", lambda: di3.query(ecql)),
            ("query_loose", lambda: di3.query(ecql, loose=True)),
        ):
            t = time.perf_counter()
            out[key] = fn()
            lat[key].append(time.perf_counter() - t)
        res3.append(out)
        # the baked dim scan (the cross-check engine) on the same window
        # against the runtime kernel's answer
        qnx, qny, ranges = zscan.z3_dim_plane_query(sfc3, *box, *window_ms(w), di3._bt_base)
        count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
        if int(count_fn(*planes3)) != out["count_loose"] or not np.array_equal(
                np.flatnonzero(mask_fn(*planes3).cpu().numpy()), np.sort(out["query_loose"].fids)):
            raise AssertionError(f"{ecql}: the baked dim scan != the runtime dim scan")
    for ecql in z2_queries:
        res2.append({
            "count_loose": di2.count(ecql, loose=True),
            "count_exact": di2.count(ecql, loose=False),
            "query_exact": di2.query(ecql),
            "query_loose": di2.query(ecql, loose=True),
        })
    q3, q2 = len(queries), len(z2_queries)
    launches = read_launches("main path (count/query)", {
        "dimscan_z3_count": q3, "dimscan_z3_mask": q3,
        "dimscan_baked_count": q3, "dimscan_baked_mask": q3,
        "dimscan_z2_count": q2, "dimscan_z2_mask": q2,
        "filter_scan_count": q3 + q2, "filter_scan_mask": q3 + q2,
    })
    for key, v in lat.items():
        log(f"latency z3 {key}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms  "
            f"({n / np.median(v) / 1e9:.2f} G rows/s at p50) [{CARD}]")
    return di3, di2, queries, z2_queries, res3, res2, launches


def np_exact(x, y, dtg, b, w=None):
    """numpy bbox(+during) over float32 rows: bounds rounded to float32 as
    the filter compiles them."""
    m = (x >= np.float32(b[0])) & (x <= np.float32(b[2]))
    m &= (y >= np.float32(b[1])) & (y <= np.float32(b[3]))
    if w is not None:
        m &= (dtg >= T0 + int(w[0] * DAY)) & (dtg <= T0 + int(w[1] * DAY))
    return m


def np_loose(q, planes):
    """numpy dim scan over host dim planes (nx, ny[, bt])."""
    m = (planes[0] >= q[0]) & (planes[0] <= q[1]) & (planes[1] >= q[2]) & (planes[1] <= q[3])
    if len(planes) == 3:
        tm = np.zeros(len(m), bool)
        for k in range((len(q) - 4) // 2):
            tm |= (planes[2] >= q[4 + 2 * k]) & (planes[2] <= q[5 + 2 * k])
        m &= tm
    return m


def host_z3_planes(cols):
    """(nx, ny, bt) uint32 dim planes from the host quantizer."""
    from geomesa_tpu_torch.curves.binnedtime import to_binned_time
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.ops import zscan

    s3 = Z3SFC()
    bins, off = to_binned_time(cols["dtg"], s3.period)
    rel = (bins - int(bins.min())).astype(np.uint32)
    hx = s3.lon.normalize(cols["geom"][:, 0]).astype(np.uint32)
    hy = s3.lat.normalize(cols["geom"][:, 1]).astype(np.uint32)
    hbt = (rel << np.uint32(21)) | s3.time.normalize(off).astype(np.uint32)
    hbt[rel >= zscan.BT_BIN_SPAN - 1] = 0xFFFFFFFF
    return hx, hy, hbt


def check_main_path(cols, di3, di2, queries, z2_queries, res3, res2):
    """Every main-path answer against numpy over the same float32 rows.
    Returns the host dim planes (z3, z2) for the later checks."""
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]
    # host dim planes from the host quantizer, held against the staged ones
    hx, hy, hbt = host_z3_planes(cols)
    s2 = Z2SFC()
    for name, h in ((Z_NX, hx), (Z_NY, hy), (Z_BT, hbt)):
        if not np.array_equal(di3._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z3 plane {name} != the host quantizer")
    h2x = s2.lon.normalize(cols["geom"][:, 0]).astype(np.uint32)
    h2y = s2.lat.normalize(cols["geom"][:, 1]).astype(np.uint32)
    for name, h in ((Z_NX, h2x), (Z_NY, h2y)):
        if not np.array_equal(di2._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z2 plane {name} != the host quantizer")

    def exact(b, w=None):
        return np_exact(x, y, dtg, b, w)

    def verify(di, ecql, b, w, out, planes, tag):
        em = exact(b, w)
        n_exact = int(em.sum())
        if out["count_exact"] != n_exact:
            raise AssertionError(f"{tag} {ecql}: exact count {out['count_exact']} != numpy {n_exact}")
        if not np.array_equal(np.sort(out["query_exact"].fids), np.nonzero(em)[0]):
            raise AssertionError(f"{tag} {ecql}: query fid set != numpy")
        lb = di._loose_bounds(parse_ecql(ecql))
        if lb is None:
            raise AssertionError(f"{tag} {ecql}: the key planes could not answer")
        lm = np_loose(lb[1], planes)
        if out["count_loose"] != int(lm.sum()) or out["count_loose"] < n_exact:
            raise AssertionError(
                f"{tag} {ecql}: loose count {out['count_loose']} vs numpy {int(lm.sum())}, "
                f"exact {n_exact}"
            )
        if not np.array_equal(np.sort(out["query_loose"].fids), np.nonzero(lm)[0]):
            raise AssertionError(f"{tag} {ecql}: loose fid set != numpy")
        if np.any(em & ~lm):
            raise AssertionError(f"{tag} {ecql}: loose is not a superset of exact")
        return n_exact, int(lm.sum())

    # one query per thread: numpy's elementwise passes release the GIL,
    # so the host's cores share the 40 full-size checks
    with ThreadPoolExecutor(max_workers=8) as pool:
        hits = list(pool.map(
            lambda a: verify(di3, *a, (hx, hy, hbt), "z3"),
            [(ecql, b, w, out) for (ecql, b, w), out in zip(queries, res3)],
        ))
        list(pool.map(
            lambda a: verify(di2, *a, (h2x, h2y), "z2"),
            [(ecql, b, None, out) for ecql, (_, b, _), out
             in zip(z2_queries, queries[: len(z2_queries)], res2)],
        ))
    ex = [h[0] for h in hits]
    lo = [h[1] for h in hits]
    log(f"checked {len(queries)} z3 + {len(z2_queries)} z2 queries against numpy in "
        f"{time.time() - t:.1f} s; z3 exact hits min/median/max "
        f"{min(ex)}/{int(np.median(ex))}/{max(ex)}, loose/exact overscan median "
        f"{np.median([l / max(e, 1) for e, l in zip(ex, lo)]):.3f}")
    return (hx, hy, hbt), (h2x, h2y)


# -- phase 3: density and stats on the same indexes ---------------------------

WORLD = (-180.0, -90.0, 180.0, 90.0)
EUROPE = (-10.0, 35.0, 30.0, 60.0)
STATS_SPEC = 'Count();MinMax("count");MinMax("dtg");Histogram("count",20,0,1000)'


def _bbox(b) -> str:
    return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"


def density_calls(queries) -> list:
    """(tag, index, filter, loose, envelope, (width, height), weight, box,
    window): the density drive; ``box``/``window`` give the exact rows
    (None: all rows), loose calls take their rows from the dim planes."""
    europe, eb, ew = queries[0]  # the bench's Europe 5-day query
    city, cb, cw = queries[12]
    na = REGIONS[1][1]
    return [
        ("world include", "z3", "INCLUDE", None, WORLD, (512, 256), None, None, None),
        ("world overview", "z3", "INCLUDE", None, WORLD, (128, 128), None, None, None),
        ("europe exact", "z3", europe, False, EUROPE, (256, 256), None, eb, ew),
        ("europe loose", "z3", europe, True, EUROPE, (256, 256), None, eb, ew),
        ("europe weighted", "z3", europe, False, EUROPE, (256, 256), "count", eb, ew),
        ("city", "z3", city, False, cb, (512, 512), None, cb, cw),
        ("north america", "z3", _bbox(na), False, na, (1024, 1024), None, na, None),
        ("world days 20-34 loose weighted", "z3", f"dtg DURING {_day(20)}/{_day(34)}",
         True, WORLD, (2048, 1024), "count", WORLD, (20, 34)),
        ("europe z2", "z2", _bbox(EUROPE), False, EUROPE, (256, 256), None, EUROPE, None),
    ]


def stats_calls(queries) -> list:
    """(tag, filter, loose, box, window, min count exclusive)."""
    europe, eb, ew = queries[0]
    asia = REGIONS[4][1]
    return [
        ("include", "INCLUDE", None, None, None, None),
        ("europe exact", europe, False, eb, ew, None),
        ("europe loose", europe, True, eb, ew, None),
        ("asia count>500", f"count > 500 AND {_bbox(asia)}", False, asia, None, 500),
    ]


def run_density_path(di3, di2, queries):
    """Every density and stats call through the public entry points, with
    the launch counts of the drive."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.geom import Envelope

    dcalls, scalls = density_calls(queries), stats_calls(queries)
    kernels.reset_counts()
    grids, lat = [], []
    for _, idx, ecql, loose, env, (w, h), weight, _, _ in dcalls:
        di = di3 if idx == "z3" else di2
        t = time.perf_counter()
        grids.append(di.density(ecql, Envelope(*env), w, h, weight_attr=weight, loose=loose))
        lat.append(time.perf_counter() - t)
    seqs = [di3.stats(ecql, STATS_SPEC, loose=loose).to_json()
            for _, ecql, loose, _, _, _ in scalls]
    launches = read_launches("main path (density/stats)", {
        "density_count": 7, "density_weighted": 2,
        "filter_scan_mask": 5 + 2, "dimscan_z3_mask": 2 + 1,
    })
    log(f"latency density ({len(lat)} calls, 2^{int(np.log2(len(di3)))} rows): "
        f"p50 {pct(lat, 50):.3f} ms  p99 {pct(lat, 99):.3f} ms; per call "
        + ", ".join(f"{c[0]} {v * 1e3:.2f}" for c, v in zip(dcalls, lat)) + f" [{CARD}]")
    return dcalls, grids, scalls, seqs, launches


def np_density(x, y, sel, env, wh, weights=None) -> np.ndarray:
    """numpy density over float32 rows: float64 pixel math, then
    np.bincount (float64 sums for weights)."""
    w, h = wh
    idx = None if sel is None else np.nonzero(sel)[0]
    xs = (x if idx is None else x[idx]).astype(np.float64)
    ys = (y if idx is None else y[idx]).astype(np.float64)
    xmin, ymin, xmax, ymax = (float(v) for v in env)
    sx, sy = w / (xmax - xmin), h / (ymax - ymin)
    inside = (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax)
    px = np.clip(np.floor((xs - xmin) * sx), 0, w - 1).astype(np.int64)
    py = np.clip(np.floor((ys - ymin) * sy), 0, h - 1).astype(np.int64)
    wt = None
    if weights is not None:
        wt = (weights if idx is None else weights[idx]).astype(np.float32).astype(np.float64)[inside]
    grid = np.bincount((py * w + px)[inside], weights=wt, minlength=w * h)
    return grid.reshape(h, w).astype(np.float32)


def same_grid(got, want, weighted) -> bool:
    if got is None or got.shape != want.shape or got.dtype != np.float32:
        return False
    if not weighted:
        return np.array_equal(got, want)
    g, w = got.astype(np.float64), want.astype(np.float64)
    return bool(np.all(np.abs(g - w) <= 1e-6 * np.abs(w)))


def np_stats(cols, sel) -> list:
    """The to_json() of STATS_SPEC over the selected rows, from numpy."""
    c = cols["count"] if sel is None else cols["count"][sel]
    d = cols["dtg"] if sel is None else cols["dtg"][sel]
    n = len(c)
    bins = np.clip(np.floor((c.astype(np.float64) - 0.0) * (20 / (1000.0 - 0.0))), 0, 19)
    mm = lambda a, v: {"type": "minmax", "attr": a, "min": int(v.min()) if n else None,  # noqa: E731
                       "max": int(v.max()) if n else None, "count": n}
    return [
        {"type": "count", "count": n}, mm("count", c), mm("dtg", d),
        {"type": "histogram", "attr": "count", "bins": 20, "lo": 0.0, "hi": 1000.0,
         "counts": np.bincount(bins.astype(np.int64), minlength=20).tolist()},
    ]


def check_density_path(cols, di3, di2, planes3, planes2, dcalls, grids, scalls, seqs):
    """Every grid and stat against numpy over the same float32 rows."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]

    def rows(di, planes, ecql, loose, box, window):
        if box is None:
            return None
        if loose:
            return np_loose(di._loose_bounds(parse_ecql(ecql))[1], planes)
        return np_exact(x, y, dtg, box, window)

    for (tag, idx, ecql, loose, env, wh, weight, box, window), got in zip(dcalls, grids):
        di, planes = (di3, planes3) if idx == "z3" else (di2, planes2)
        sel = rows(di, planes, ecql, loose, box, window)
        want = np_density(x, y, sel, env, wh, cols["count"] if weight else None)
        if not same_grid(got, want, weight is not None):
            raise AssertionError(f"density {tag}: grid != numpy")
        if not weight and want.sum() == 0:
            raise AssertionError(f"density {tag}: an empty grid checks nothing")
    for (tag, ecql, loose, box, window, cmin), got in zip(scalls, seqs):
        sel = rows(di3, planes3, ecql, loose, box, window)
        if cmin is not None:
            sel &= cols["count"] > cmin
        if got != np_stats(cols, sel):
            raise AssertionError(f"stats {tag}: {got} != numpy {np_stats(cols, sel)}")
    log(f"checked {len(dcalls)} density grids and {len(scalls)} stats against numpy "
        f"in {time.time() - t:.1f} s")


# -- phase 3c: the interleaved key layout --------------------------------------

WIDE_T0 = 1_424_217_600_000  # 2015-02-18T00:00:00Z
WIDE_T1 = 1_735_689_600_000  # 2025-01-01T00:00:00Z, exclusive
WIDE_SPEC = GDELT_SPEC + ";geomesa.z3.interval=day"
WIDE_SAMPLE = 1 << 23  # rows of the host-encoded subsample


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def wide_queries(centers: np.ndarray) -> list:
    """(ecql, box, (t0, t1) ms) over the day-binned data: windows of 1 day
    to 8 weeks (2 to 57 bins: the interleaved scan), then 70 and 180 days
    (past 64 bins: the filter scan). The short windows take boxes around
    cluster centres, so that the subsample holds hits."""
    spans = [(100.25, 1), (731, 3), (1200, 7), (1800.5, 14), (2500, 28), (3000, 56),
             (3300, 70), (1000, 180)]
    city = [tuple(round(float(v), 3) for v in (c[0] - h, c[1] - h, c[0] + h, c[1] + h))
            for c, h in ((centers[0], 1.0), (centers[1], 2.0))]
    boxes = city + [REGIONS[i][1] for i in (1, 4, 11, 3, 0, 2)]
    out = []
    for (d0, days), b in zip(spans, boxes):
        t0, t1 = WIDE_T0 + int(d0 * DAY), WIDE_T0 + int((d0 + days) * DAY)
        out.append((f"{_bbox(b)} AND dtg DURING {_iso(t0)}/{_iso(t1)}", b, (t0, t1)))
    return out


def np_zscan(bins, z, bounds, ids) -> np.ndarray:
    """numpy masked compare over host-encoded uint64 keys: any entry with
    id >= 0 and id == bin whose dims all hold lo <= (z & mask) <= hi."""
    u = np.uint64
    m = np.zeros(len(z), bool)
    for e, bid in zip(bounds, ids):
        if bid < 0:
            continue
        hit = bins == bid
        for w in e.astype(np.uint64):
            zm = z & ((w[0] << u(32)) | w[1])
            hit &= (zm >= ((w[2] << u(32)) | w[3])) & (zm <= ((w[4] << u(32)) | w[5]))
        m |= hit
    return m


def _staged_keys_match(di, idx, z, bins=None) -> None:
    """The interleaved planes at rows ``idx`` against host-encoded keys."""
    import torch

    from geomesa_tpu_torch.curves.zorder import u64_hi_lo
    from geomesa_tpu_torch.device_cache import Z_BIN, Z_HI, Z_LO

    hi, lo = u64_hi_lo(z)
    ti = torch.from_numpy(idx).to(di.device)
    for name, want in ((Z_HI, hi), (Z_LO, lo), (Z_BIN, bins)):
        if want is None:
            continue
        # gather through an int32 view: CUDA has no uint32 indexing
        got = di._cols[name].view(torch.int32)[ti].cpu().numpy().view(want.dtype)
        if not np.array_equal(got, want):
            raise AssertionError(f"staged {name} != the host encode")


def _stage(dev, store, type_name, **kw):
    import torch

    from geomesa_tpu_torch.device_cache import Z_HI, DeviceIndex

    t = time.time()
    di = DeviceIndex(store, type_name, z_planes=True, device=dev, **kw)
    torch.cuda.synchronize()
    if di._dim_mode or Z_HI not in di._cols:
        raise AssertionError(f"{type_name}: not in the interleaved layout")
    return di, time.time() - t


def run_interleaved_path(dev, cols, di3, di2, queries, z2_queries, res3, res2, planes2,
                         dcalls, grids, scalls, seqs) -> dict:
    """Stage the interleaved Z3 and Z2 indexes over the main path's rows and
    a day-binned index over 2015-2024; drive them through the entry points
    (three drives, each with its launch counts) and check every answer."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.store.direct import BatchStore

    n = len(cols["count"])
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    idx = np.sort(np.random.default_rng(SEED + 5).choice(n, WIDE_SAMPLE, replace=False))
    xs, ys = cols["geom"][idx, 0], cols["geom"][idx, 1]
    totals = {k: 0 for k in kernels.KERNEL_NAMES}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # 1. interleaved Z3 on the week-binned main-path rows
    di3i, st3 = _stage(dev, di3.store, "gdelt", dim_planes=False)
    bins_s, off_s = to_binned_time(cols["dtg"][idx], TimePeriod.WEEK)
    _staged_keys_match(di3i, idx, Z3SFC().index(xs, ys, off_s), bins_s.astype(np.int32))
    kernels.reset_counts()
    got3, lat = [], []
    for ecql, _, _ in queries:
        t = time.perf_counter()
        c = di3i.count(ecql, loose=True)
        lat.append(time.perf_counter() - t)
        got3.append((c, di3i.mask(ecql, loose=True), di3i.query(ecql, loose=True).fids))
    dens = [di3i.density(dcalls[i][2], Envelope(*dcalls[i][4]), *dcalls[i][5],
                         weight_attr=dcalls[i][6], loose=True) for i in (3, 7)]
    seq = di3i.stats(scalls[2][1], STATS_SPEC, loose=True).to_json()
    q3 = len(queries)
    add(read_launches("interleaved z3", {
        "zscan_z3_count": q3, "zscan_z3_mask": 2 * q3 + 3,
        "density_count": 1, "density_weighted": 1,
    }))
    for (ecql, _, _), (c, m, fids), want in zip(queries, got3, res3):
        loose = np.sort(want["query_loose"].fids)
        if c != want["count_loose"] or not np.array_equal(np.flatnonzero(m), loose) \
                or not np.array_equal(np.sort(fids), loose):
            raise AssertionError(f"interleaved z3 {ecql}: loose answer != the dim-plane index's")
    if not (same_grid(dens[0], grids[3], False) and same_grid(dens[1], grids[7], True)):
        raise AssertionError("interleaved z3: loose density != the dim-plane index's")
    if seq != seqs[2]:
        raise AssertionError(f"interleaved z3: loose stats {seq} != {seqs[2]}")
    log(f"phase 3c: interleaved z3 staged in {st3:.2f} s ({di3i.nbytes / 1e9:.3f} GB resident); "
        f"{q3} loose counts, masks and fid sets, 2 loose density grids and a loose stats call "
        f"equal to the dim-plane index's; count(loose=True) p50 {pct(lat, 50):.3f} ms "
        f"p99 {pct(lat, 99):.3f} ms [{CARD}]")

    # 2. interleaved Z2 on the date-less sibling
    di2i, st2 = _stage(dev, di2.store, "points", dim_planes=False)
    _staged_keys_match(di2i, idx, Z2SFC().index(xs, ys))
    kernels.reset_counts()
    got2 = [(di2i.count(ecql, loose=True), di2i.mask(ecql, loose=True),
             di2i.query(ecql, loose=True).fids) for ecql in z2_queries]
    g2 = di2i.density(_bbox(EUROPE), Envelope(*EUROPE), 256, 256, loose=True)
    q2 = len(z2_queries)
    add(read_launches("interleaved z2", {
        "zscan_z2_count": q2, "zscan_z2_mask": 2 * q2 + 1, "density_count": 1,
    }))
    for ecql, (c, m, fids), want in zip(z2_queries, got2, res2):
        loose = np.sort(want["query_loose"].fids)
        if c != want["count_loose"] or not np.array_equal(np.flatnonzero(m), loose) \
                or not np.array_equal(np.sort(fids), loose):
            raise AssertionError(f"interleaved z2 {ecql}: loose answer != the dim-plane index's")
    sel = np_loose(di2._loose_bounds(parse_ecql(_bbox(EUROPE)))[1], planes2)
    if not same_grid(g2, np_density(x, y, sel, EUROPE, (256, 256)), False):
        raise AssertionError("interleaved z2: loose density != numpy")
    log(f"phase 3c: interleaved z2 staged in {st2:.2f} s ({di2i.nbytes / 1e9:.3f} GB resident); "
        f"{q2} loose counts, masks and fid sets equal to the dim-plane index's, "
        f"a loose density grid equal to numpy")

    # 3. day bins over ten years: the staging falls back by itself
    t = time.time()
    dtg_w = np.random.default_rng(SEED + 6).integers(WIDE_T0, WIDE_T1, n)
    sftw = SimpleFeatureType.create("gdelt_wide", WIDE_SPEC)
    bw = FeatureBatch.from_columns(sftw, {"count": cols["count"], "dtg": dtg_w, "geom": cols["geom"]})
    diw, stw = _stage(dev, BatchStore(bw), "gdelt_wide")
    span = diw._bin_range[1] - diw._bin_range[0] + 1
    if span <= 2047:
        raise AssertionError(f"the wide index spans only {span} bins")
    bins_s, off_s = to_binned_time(dtg_w[idx], TimePeriod.DAY)
    z_s = Z3SFC(TimePeriod.DAY).index(xs, ys, off_s)
    _staged_keys_match(diw, idx, z_s, bins_s.astype(np.int32))
    wq = wide_queries(cols["_centers"])
    lbs = [diw._loose_bounds(parse_ecql(ecql)) for ecql, _, _ in wq]
    wide_bins = [None if lb is None else int((lb[2] >= 0).sum()) for lb in lbs]
    kernels.reset_counts()
    gotw = [(diw.count(ecql, loose=True), diw.count(ecql), diw.mask(ecql, loose=True))
            for ecql, _, _ in wq]
    short = sum(b is not None for b in wide_bins)
    add(read_launches("wide span", {
        "zscan_z3_count": short, "zscan_z3_mask": short,
        "filter_scan_count": len(wq) + (len(wq) - short), "filter_scan_mask": len(wq) - short,
    }))
    if short == len(wq) or short == 0:
        raise AssertionError(f"wide span: bins per window {wide_bins} miss a route")
    xw, yw = x[idx], y[idx]

    def check(i):
        (ecql, b, (t0, t1)), lb, (c_loose, c_exact, m) = wq[i], lbs[i], gotw[i]
        em = (x >= np.float32(b[0])) & (x <= np.float32(b[2])) & (y >= np.float32(b[1])) \
            & (y <= np.float32(b[3])) & (dtg_w >= t0) & (dtg_w <= t1)
        if c_exact != int(em.sum()):
            raise AssertionError(f"wide {ecql}: exact count {c_exact} != numpy {int(em.sum())}")
        if lb is None:  # past 64 bins: the exact scan answers
            if c_loose != c_exact or not np.array_equal(m, em):
                raise AssertionError(f"wide {ecql}: loose past 64 bins != exact")
            return c_exact, c_loose, None
        lm = np_zscan(bins_s, z_s, lb[1], lb[2])
        if not np.array_equal(m[idx], lm) or c_loose != int(m.sum()) or np.any(em & ~m):
            raise AssertionError(f"wide {ecql}: loose mask != numpy over host keys")
        if not lm.any():
            raise AssertionError(f"wide {ecql}: the subsample holds no hit")
        return c_exact, c_loose, int(lm.sum())

    with ThreadPoolExecutor(max_workers=8) as pool:
        checked = list(pool.map(check, range(len(wq))))
    log(f"phase 3c: wide span ({n:,} rows, {span} day bins) generated and staged in "
        f"{time.time() - t:.2f} s (staging {stw:.2f} s, {diw.nbytes / 1e9:.3f} GB resident); "
        f"bins per window {wide_bins} (None: past 64, the filter scan); exact/loose/subsample "
        f"hits {checked}; all equal to numpy")
    return {"di3i": di3i, "di2i": di2i, "diw": diw, "launches": totals, "wide": wq}


# -- phase 3b: per-request visibility -----------------------------------------

LABELS = ["", "A", "B", "A&B", "A|C", "(A|B)&C"]
VERDICTS = {  # auths -> whether each of LABELS is visible, written out by hand
    None: [True, False, False, False, False, False],
    ("A",): [True, True, False, False, True, False],
    ("A", "B", "C"): [True, True, True, True, True, True],
}
N_LABELED = 1 << 24


def run_labeled_path(dev, queries):
    """Stage a labeled Z3 index and drive count, query, density and a
    Count() stat under each auth set of VERDICTS; check with numpy."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import VIS_ID, DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.store.direct import BatchStore

    t = time.time()
    cols = make_columns(N_LABELED, SEED + 3)
    lab = np.random.default_rng(SEED + 4).integers(0, len(LABELS), N_LABELED)
    data = {k: cols[k] for k in ("count", "dtg", "geom")}
    data[VIS_COLUMN] = np.array(LABELS, dtype=object)[lab]
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("gdelt", GDELT_SPEC), data)
    gen = time.time() - t
    t = time.time()
    di = DeviceIndex(BatchStore(batch), "gdelt", z_planes=True, device=dev)
    torch.cuda.synchronize()
    log(f"phase 3b: generated {N_LABELED:,} labeled rows in {gen:.1f} s; staged in "
        f"{time.time() - t:.1f} s (label vocabulary {len(di._vis_vocab)}, "
        f"{di.nbytes / 1e9:.3f} GB resident)")
    if VIS_ID not in di._cols:
        raise AssertionError("the labeled index staged no label-id plane")
    europe, eb, ew = queries[0]
    kernels.reset_counts()
    res = {}
    for auths in VERDICTS:
        res[auths] = (
            di.count(europe, loose=True, auths=auths),
            di.count(europe, auths=auths),
            di.query(europe, auths=auths).fids,
            di.query(europe, loose=True, auths=auths).fids,
            di.density(europe, Envelope(*EUROPE), 256, 256, auths=auths),
            di.density("INCLUDE", Envelope(*WORLD), 512, 256, auths=auths),
            di.stats(europe, "Count()", auths=auths).to_json()[0]["count"],
        )
    k = len(VERDICTS)
    launches = read_launches("labeled path", {
        "dimscan_z3_mask": 2 * k, "filter_scan_mask": 4 * k, "density_count": 2 * k,
    })
    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    em = np_exact(x, y, cols["dtg"], eb, ew)
    lm = np_loose(di._loose_bounds(parse_ecql(europe))[1], host_z3_planes(cols))
    for auths, (c_loose, c_exact, f_exact, f_loose, g_eu, g_all, n_stat) in res.items():
        seen = np.asarray(VERDICTS[auths])[lab]
        ex, lo = em & seen, lm & seen
        if c_exact != int(ex.sum()) or n_stat != c_exact or c_loose != int(lo.sum()):
            raise AssertionError(f"labeled {auths}: counts {c_exact}/{n_stat}/{c_loose} != numpy")
        if not (np.array_equal(np.sort(f_exact), np.nonzero(ex)[0])
                and np.array_equal(np.sort(f_loose), np.nonzero(lo)[0])):
            raise AssertionError(f"labeled {auths}: fid sets != numpy")
        if not (same_grid(g_eu, np_density(x, y, ex, EUROPE, (256, 256)), False)
                and same_grid(g_all, np_density(x, y, seen, WORLD, (512, 256)), False)):
            raise AssertionError(f"labeled {auths}: density grid != numpy")
        log(f"labeled auths={auths}: exact {c_exact}, loose {c_loose}, "
            f"visible rows {int(seen.sum())}")
    log(f"checked the labeled path against numpy in {time.time() - t:.1f} s")
    return launches


# -- phase 4: kernel timings --------------------------------------------------


def time_ms(fn, iters: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _program_ops(prog) -> int:
    from geomesa_tpu_torch.ops import filter_scan as fs

    per = {fs.OP_BBOX: 7, fs.OP_BBOX_ENV: 7, fs.OP_DWITHIN: 6, fs.OP_CMP_F32: 1,
           fs.OP_CMP_I32: 1, fs.OP_CMP_I64: 5, fs.OP_AND: 1, fs.OP_OR: 1, fs.OP_NOT: 1}
    ops = 0
    for op, *_, n_edges, _ in prog.instr.tolist():
        ops += 9 * n_edges + 2 if op == fs.OP_PIP else per.get(op, 0)
    return ops


def zscan_ops(lb, bins) -> int:
    """Integer operations of the interleaved scan on this data: per row an
    id compare and branch per (padded) entry, and about 25 for the masked
    compares of the entry its bin matches (counted where one does)."""
    import torch

    ids = lb[2]
    n = bins.shape[0]
    if ids is None:  # z2: one entry, 2 dims
        return 17 * n
    real = torch.from_numpy(ids[ids >= 0]).to(bins.device)
    in_window = int(torch.isin(bins, real).sum())
    return 2 * len(ids) * n + 25 * in_window


def kernel_table(dev, di3, di2, inter, queries, z2_queries, launches, errs: Errs) -> list:
    """Time each kernel at the main path's shapes; compare it with its
    plain version on those inputs too."""
    import torch

    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan, zscan

    n = len(di3)
    ecql = queries[0][0]  # the bench's Europe 5-day query
    _, q3, r3 = di3._loose_bounds(parse_ecql(ecql))
    p3 = (di3._cols[Z_NX], di3._cols[Z_NY], di3._cols[Z_BT])
    _, q2, _ = di2._loose_bounds(parse_ecql(z2_queries[0]))
    p2 = (di2._cols[Z_NX], di2._cols[Z_NY])
    cf = di3._compiled_for(parse_ecql(ecql))
    fcols = di3._resident_subset(cf)
    fbytes = 4 * len(cf.program.cols)
    rows = []

    def row(name, source, replaces, kern, plain, in_bytes, out_bytes, ops, plain_iters=5):
        got, want = kern(), plain()
        errs.check(name, got.reshape(-1), want.reshape(-1), "main-path shapes")
        ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, plain_iters, warm=min(3, plain_iters))
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"{name}: {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms: bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}; {(in_bytes + out_bytes) / ms / 1e6:.1f} GB/s, "
            f"{n / ms / 1e6:.2f} G rows/s); plain version {plain_ms:.3f} ms (not a yardstick) "
            f"[{CARD}]")

    dim_src = "geomesa_tpu_torch/csrc/dimscan.cu"
    fs_src = "geomesa_tpu_torch/csrc/filter_scan.cu"
    rz3 = "geomesa_tpu/ops/zscan.py:548 build_z3_dimscan_rt"
    rz2 = "geomesa_tpu/ops/zscan.py:438 build_z2_dimscan_rt"
    rfs = "geomesa_tpu/ops/pallas_scan.py:203 build_pallas_scan"
    row("dimscan_z3_count", dim_src, f"{rz3} (pallas_call :643)",
        lambda: zscan.dimscan_count(q3, *p3),
        lambda: zscan.dimscan_plain(q3, *p3).sum(dtype=torch.int32),
        12 * n, 4, n * (4 + 2 * r3 + 3))
    row("dimscan_z3_mask", dim_src, f"{rz3} (pallas_call :669)",
        lambda: zscan.dimscan_mask(q3, *p3), lambda: zscan.dimscan_plain(q3, *p3),
        12 * n, n, n * (4 + 2 * r3 + 3))
    row("dimscan_z2_count", dim_src, f"{rz2} (pallas_call :498)",
        lambda: zscan.dimscan_count(q2, *p2),
        lambda: zscan.dimscan_plain(q2, *p2).sum(dtype=torch.int32),
        8 * n, 4, n * 7)
    row("dimscan_z2_mask", dim_src, f"{rz2} (pallas_call :521)",
        lambda: zscan.dimscan_mask(q2, *p2), lambda: zscan.dimscan_plain(q2, *p2),
        8 * n, n, n * 7)

    # the baked dim scan on the same window, beside the runtime kernel
    w = window_ms(queries[0][2])
    qnx, qny, ranges = zscan.z3_dim_plane_query(Z3SFC(), *queries[0][1], *w, di3._bt_base)
    bc, bm = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
    bake_src = "geomesa_tpu_torch/csrc/dimscan_baked.cu"
    rbake = "geomesa_tpu/ops/zscan.py:703 build_z3_dimscan_pallas"
    bake_ops = n * (4 + 2 * len(ranges) + 3)
    row("dimscan_baked_count", bake_src, f"{rbake} (pallas_call :772)", lambda: bc(*p3),
        lambda: zscan.z3_dimscan_mask(*p3, qnx, qny, ranges).sum(dtype=torch.int32),
        12 * n, 4, bake_ops)
    row("dimscan_baked_mask", bake_src, f"{rbake} (pallas_call :790)", lambda: bm(*p3),
        lambda: zscan.z3_dimscan_mask(*p3, qnx, qny, ranges), 12 * n, n, bake_ops)

    # the interleaved scan: a 2-bin main-path window (Africa, days 6-13)
    zs_src = "geomesa_tpu_torch/csrc/zscan.cu"
    rzs = "geomesa_tpu/ops/zscan.py:848 build_z3_pallas_scan"
    di3i, di2i = inter["di3i"], inter["di2i"]
    lb = di3i._loose_bounds(parse_ecql(queries[3][0]))
    zc, zm, ops3 = di3i._loose_args(lb)
    bounds, ids = lb[1], lb[2]
    zops = zscan_ops(lb, ops3[0])
    log(f"zscan_z3 timing window: {queries[3][0]} ({int((ids >= 0).sum())} bins, "
        f"{len(ids)} entries)")
    row("zscan_z3_count", zs_src, f"{rzs} (pallas_call :942)", lambda: zc(*ops3),
        lambda: zscan.z3_zscan_mask(ops3[1], ops3[2], ops3[0], bounds, ids).sum(dtype=torch.int32),
        12 * n, 4, zops, plain_iters=2)
    row("zscan_z3_mask", zs_src, f"{rzs} (pallas_call :960)", lambda: zm(*ops3),
        lambda: zscan.z3_zscan_mask(ops3[1], ops3[2], ops3[0], bounds, ids),
        12 * n, n, zops, plain_iters=2)
    lb2 = di2i._loose_bounds(parse_ecql(z2_queries[0]))
    z2c, z2m, ops2 = di2i._loose_args(lb2)
    row("zscan_z2_count", zs_src, f"{rzs} (pallas_call :942; z2 variant of zscan.py:97)",
        lambda: z2c(*ops2),
        lambda: zscan.z2_zscan_mask(*ops2, lb2[1]).sum(dtype=torch.int32), 8 * n, 4, 17 * n)
    row("zscan_z2_mask", zs_src, f"{rzs} (pallas_call :960; z2 variant of zscan.py:97)",
        lambda: z2m(*ops2), lambda: zscan.z2_zscan_mask(*ops2, lb2[1]), 8 * n, n, 17 * n)

    # the interleaved scan at 28 day bins (the wide index, kernel only)
    diw, (wq, _, _) = inter["diw"], inter["wide"][4]
    lbw = diw._loose_bounds(parse_ecql(wq))
    wc, wm, opsw = diw._loose_args(lbw)
    nb = int((lbw[2] >= 0).sum())
    zops_w = zscan_ops(lbw, opsw[0])
    for name, fn, out_b in (("zscan_z3_count", wc, 4), ("zscan_z3_mask", wm, n)):
        ms = time_ms(lambda f=fn: f(*opsw), 20)
        t_bytes = (12 * n + out_b) / HBM_BYTES_PER_S * 1e3
        log(f"{name} at {nb} day bins ({len(lbw[2])} entries): {ms:.4f} ms; bytes bound "
            f"{t_bytes:.4f} ms, operations bound {zops_w / INT32_OPS_PER_S * 1e3:.4f} ms "
            f"(this kernel: {zops_w / n:.1f} ops/row), {25 * nb * n / INT32_OPS_PER_S * 1e3:.4f} ms "
            f"at 25 ops per row per bin entry (the TPU kernel's way) [{CARD}]")

    ops = n * _program_ops(cf.program)
    row("filter_scan_count", fs_src, f"{rfs} (pallas_call :284)",
        lambda: filter_scan.filter_scan_count(cf.program, fcols),
        lambda: filter_scan.run_program_plain(cf.program, fcols).sum(dtype=torch.int32),
        fbytes * n, 4, ops)
    row("filter_scan_mask", fs_src, f"{rfs} (pallas_call :304)",
        lambda: filter_scan.filter_scan_mask(cf.program, fcols),
        lambda: filter_scan.run_program_plain(cf.program, fcols),
        fbytes * n, n, ops)
    return rows


def density_rows(dev, di3, launches, errs: Errs) -> list:
    """Time the density kernel on the main path's 2^26 rows with every row
    masked in (the heaviest case: each row adds to the grid) over the world
    viewport: the main path's clustered points and uniform points, at
    256x256 and 1024x1024, counted and weighted (float32 weights, cast
    before timing). Beside it: the plain version and one torch.bincount
    over precomputed flat ids (computes less: ids precomputed). The kernel
    table's row is the clustered 256x256 case. Then a counted 128x128
    grid on each of the kernel's two engines."""
    import torch

    from geomesa_tpu_torch.ops.density import _launch, density_grid, density_plain, pixel_ids

    n = len(di3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    uni = [(torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * s - s / 2)
           .to(torch.float32) for s in (360.0, 180.0)]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    wts = di3._cols["count"].to(torch.float32)
    found = {}
    for data, (px, py) in (("clustered", (di3._cols["geom__x"], di3._cols["geom__y"])),
                           ("uniform", uni)):
        for width, height in ((256, 256), (1024, 1024)):
            ix, iy, inside = pixel_ids(px, py, WORLD, width, height)
            flat = (iy.to(torch.int64) * width + ix.to(torch.int64))[inside]
            del ix, iy
            for w in (None, wts):
                name = "density_count" if w is None else "density_weighted"
                args = (px, py, WORLD, width, height)
                kern = lambda a=args, w=w: density_grid(*a, mask=ones, weights=w)  # noqa: E731
                plain = lambda a=args, w=w: density_plain(*a, mask=ones, weights=w)  # noqa: E731
                wf = None if w is None else w[inside]
                lib = lambda f=flat, wf=wf, c=width * height: torch.bincount(  # noqa: E731
                    f, weights=wf, minlength=c)
                what = f"{data} {width}x{height} main-path shapes"
                errs.check_grid(name, kern(), plain(), 0.0 if w is None else 1e-6, what)
                ms, plain_ms, lib_ms = time_ms(kern, 20), time_ms(plain, 2), time_ms(lib, 10)
                nbytes = (9 if w is None else 13) * n + 4 * width * height
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 12 * n / F64_OPS_PER_S * 1e3  # float64 pixel math per row
                bound = max(t_bytes, t_ops)
                found[(data, width, name)] = (ms, plain_ms, lib_ms, bound,
                                              "bytes" if t_bytes >= t_ops else "operations")
                log(f"{name} {data} {width}x{height}: {ms:.4f} ms (bound {bound:.4f} ms, "
                    f"{100 * bound / ms:.1f}% of it, {n / ms / 1e6:.2f} G rows/s); "
                    f"torch.bincount {lib_ms:.4f} ms (computes less: ids precomputed); "
                    f"plain version {plain_ms:.3f} ms (not a yardstick) [{CARD}]")
            del flat, inside
        # a counted grid that takes the shared-memory engine, timed on it
        # and on the global engine: the measurement behind the split
        args = (px, py, WORLD, 128, 128, ones, None)
        want = density_plain(*args[:5], mask=ones)
        t = {}
        for shared in (True, False):
            kern = lambda s=shared: _launch(*args, shared=s)  # noqa: E731
            errs.check_grid("density_count", kern(), want, 0.0,
                            f"{data} 128x128 {'shared-memory' if shared else 'global'} engine")
            t[shared] = time_ms(kern, 20)
        log(f"density_count {data} 128x128: shared-memory engine {t[True]:.4f} ms, "
            f"global engine {t[False]:.4f} ms [{CARD}]")
    src = "geomesa_tpu_torch/csrc/density.cu"
    rep = "geomesa_tpu/ops/density_pallas.py:42 build_density_pallas (pallas_call :124)"
    rows = []
    for name in ("density_count", "density_weighted"):
        ms, plain_ms, lib_ms, bound, bound_by = found[("clustered", 256, name)]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from geomesa_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the geomesa_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    global CARD
    t_all = time.time()
    dev = torch.device("cuda:0")
    CARD = card_line()
    log(f"phase 0: {CARD}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    t = time.time()
    logs = _build.build_all()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in {time.time() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t = time.time()
    errs = Errs()
    check_dimscans(dev, errs)
    check_baked_dimscans(dev, errs)
    check_zscans(dev, errs)
    check_filter_scans(dev, errs)
    check_density(dev, errs)
    log(f"phase 2: kernels == plain versions, bit-exact (weighted density: rtol 1e-6) "
        f"({time.time() - t:.1f} s)")

    t = time.time()
    cols = make_columns(N_ROWS, SEED)
    log(f"phase 3: generated {N_ROWS:,} rows in {time.time() - t:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    di3, di2, queries, z2q, res3, res2, main_launches = run_main_path(dev, cols)
    planes3, planes2 = check_main_path(cols, di3, di2, queries, z2q, res3, res2)
    dcalls, grids, scalls, seqs, dens_launches = run_density_path(di3, di2, queries)
    check_density_path(cols, di3, di2, planes3, planes2, dcalls, grids, scalls, seqs)
    inter = run_interleaved_path(dev, cols, di3, di2, queries, z2q, res3, res2, planes2,
                                 dcalls, grids, scalls, seqs)
    del planes3, planes2, grids, res3, res2
    lab_launches = run_labeled_path(dev, queries)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    launches = {k: main_launches[k] + dens_launches[k] + inter["launches"][k] + lab_launches[k]
                for k in main_launches}

    rows = kernel_table(dev, di3, di2, inter, queries, z2q, launches, errs)
    rows += density_rows(dev, di3, launches, errs)
    log(json.dumps({"kernels": rows}))
    log(f"total {time.time() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
