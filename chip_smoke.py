#!/usr/bin/env python3
"""Drive geomesa_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, bit-exact,
     at ragged sizes with edge rows (dim scans at R in {1,2,4,8} and z2;
     the filter scan over a fixed filter list);
  3. the main path at full size: a GDELT-shaped resident Z3 point type
     (count:Int,dtg:Date,*geom:Point, 2^26 rows from a fixed seed: 90% of
     points in 64 city clusters, coordinates float32, dtg over 60 days from
     2020-01-01) and its date-less Z2 sibling, staged through
     DeviceIndex(BatchStore(batch)) and queried with 32 bbox+during
     filters through count(loose=True), count(loose=False), query() and
     query(loose=True); every answer is checked on the host with numpy,
     and the launch counts show which kernels carried the queries;
  4. each kernel's time at the main path's shapes (CUDA events) beside its
     bound and its plain version's time.

Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20200101
N_ROWS = 1 << 26
T0 = 1_577_836_800_000  # 2020-01-01T00:00:00Z
DAY = 86_400_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
GDELT_SPEC = "count:Int,dtg:Date,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,*geom:Point:srid=4326"


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


def pct(v, p):
    return float(np.percentile(np.asarray(v) * 1e3, p))


def run_main_path(dev, cols):
    """Stage both indexes, then run every query through the public entry
    points; return timings and the state the checks need."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY, DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
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
    kernels.reset_counts()
    for ecql, _, _ in queries:
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
    for ecql in z2_queries:
        res2.append({
            "count_loose": di2.count(ecql, loose=True),
            "count_exact": di2.count(ecql, loose=False),
            "query_exact": di2.query(ecql),
            "query_loose": di2.query(ecql, loose=True),
        })
    launches = dict(kernels.LAUNCHES)
    fallbacks = dict(kernels.DEVICE_FN_CALLS)
    q3, q2 = len(queries), len(z2_queries)
    want = {
        "dimscan_z3_count": q3, "dimscan_z3_mask": q3,
        "dimscan_z2_count": q2, "dimscan_z2_mask": q2,
        "filter_scan_count": q3 + q2, "filter_scan_mask": q3 + q2,
    }
    log("main-path launches:", json.dumps(launches), "device_fn calls:", json.dumps(fallbacks))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != the calls made {want}")
    if any(fallbacks.values()):
        raise AssertionError(f"device_fn served main-path scans: {fallbacks}")
    for key, v in lat.items():
        log(f"latency z3 {key}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms  "
            f"({n / np.median(v) / 1e9:.2f} G rows/s at p50)")
    return di3, di2, queries, z2_queries, res3, res2, launches


def check_main_path(cols, di3, di2, queries, z2_queries, res3, res2):
    """Every main-path answer against numpy over the same float32 rows."""
    from geomesa_tpu_torch.curves.binnedtime import to_binned_time
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import zscan

    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]
    # host dim planes from the host quantizer, held against the staged ones
    s3, s2 = Z3SFC(), Z2SFC()
    bins, off = to_binned_time(dtg, s3.period)
    base = int(bins.min())
    rel = (bins - base).astype(np.uint32)
    hx = s3.lon.normalize(cols["geom"][:, 0]).astype(np.uint32)
    hy = s3.lat.normalize(cols["geom"][:, 1]).astype(np.uint32)
    hbt = (rel << np.uint32(21)) | s3.time.normalize(off).astype(np.uint32)
    hbt[rel >= zscan.BT_BIN_SPAN - 1] = 0xFFFFFFFF
    for name, h in ((Z_NX, hx), (Z_NY, hy), (Z_BT, hbt)):
        if not np.array_equal(di3._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z3 plane {name} != the host quantizer")
    h2x = s2.lon.normalize(cols["geom"][:, 0]).astype(np.uint32)
    h2y = s2.lat.normalize(cols["geom"][:, 1]).astype(np.uint32)
    for name, h in ((Z_NX, h2x), (Z_NY, h2y)):
        if not np.array_equal(di2._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z2 plane {name} != the host quantizer")

    def exact(b, w=None):
        m = (x >= np.float32(b[0])) & (x <= np.float32(b[2]))
        m &= (y >= np.float32(b[1])) & (y <= np.float32(b[3]))
        if w is not None:
            m &= (dtg >= T0 + int(w[0] * DAY)) & (dtg <= T0 + int(w[1] * DAY))
        return m

    def loose(q, planes):
        m = (planes[0] >= q[0]) & (planes[0] <= q[1]) & (planes[1] >= q[2]) & (planes[1] <= q[3])
        if len(planes) == 3:
            tm = np.zeros(len(m), bool)
            for k in range((len(q) - 4) // 2):
                tm |= (planes[2] >= q[4 + 2 * k]) & (planes[2] <= q[5 + 2 * k])
            m &= tm
        return m

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
        lm = loose(lb[0], planes)
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

    hits = []
    for (ecql, b, w), out in zip(queries, res3):
        hits.append(verify(di3, ecql, b, w, out, (hx, hy, hbt), "z3"))
    for ecql, (_, b, _), out in zip(z2_queries, queries[: len(z2_queries)], res2):
        verify(di2, ecql, b, None, out, (h2x, h2y), "z2")
    ex = [h[0] for h in hits]
    lo = [h[1] for h in hits]
    log(f"checked {len(queries)} z3 + {len(z2_queries)} z2 queries against numpy in "
        f"{time.time() - t:.1f} s; z3 exact hits min/median/max "
        f"{min(ex)}/{int(np.median(ex))}/{max(ex)}, loose/exact overscan median "
        f"{np.median([l / max(e, 1) for e, l in zip(ex, lo)]):.3f}")


# -- phase 4: kernel timings --------------------------------------------------


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
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


def kernel_table(dev, di3, di2, queries, z2_queries, launches, errs: Errs) -> list:
    """Time each kernel at the main path's shapes; compare it with its
    plain version on those inputs too."""
    import torch

    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan, zscan

    n = len(di3)
    ecql = queries[0][0]  # the bench's Europe 5-day query
    q3, r3 = di3._loose_bounds(parse_ecql(ecql))
    p3 = (di3._cols[Z_NX], di3._cols[Z_NY], di3._cols[Z_BT])
    q2, _ = di2._loose_bounds(parse_ecql(z2_queries[0]))
    p2 = (di2._cols[Z_NX], di2._cols[Z_NY])
    cf = di3._compiled_for(parse_ecql(ecql))
    fcols = di3._resident_subset(cf)
    fbytes = 4 * len(cf.program.cols)
    rows = []

    def row(name, source, replaces, kern, plain, in_bytes, out_bytes, ops):
        got, want = kern(), plain()
        errs.check(name, got.reshape(-1), want.reshape(-1), "main-path shapes")
        ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"{name}: {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms, "
            f"{(in_bytes + out_bytes) / ms / 1e6:.1f} GB/s, {n / ms / 1e6:.2f} G rows/s); "
            f"plain version {plain_ms:.3f} ms (not a yardstick)")

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
    t_all = time.time()
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"phase 0: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
    check_filter_scans(dev, errs)
    log(f"phase 2: kernels == plain versions, bit-exact ({time.time() - t:.1f} s)")

    t = time.time()
    cols = make_columns(N_ROWS, SEED)
    log(f"phase 3: generated {N_ROWS:,} rows in {time.time() - t:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    di3, di2, queries, z2q, res3, res2, launches = run_main_path(dev, cols)
    check_main_path(cols, di3, di2, queries, z2q, res3, res2)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    rows = kernel_table(dev, di3, di2, queries, z2q, launches, errs)
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
