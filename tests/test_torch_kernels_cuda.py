"""CUDA kernels of ``geomesa_tpu_torch`` against their plain PyTorch
versions, on the card. Bit-exact: counts, masks and unweighted density
grids are integers and the float arithmetic is rounded op by op on both
sides. Weighted density grids sum in float64 in a run-dependent order, so
they match within rtol 1e-6.

Marked ``cuda``; every test skips where there is no CUDA device (decided
inside the fixture, never at import). The machine with the card has no
JAX, and ``tests/conftest.py`` loads it, so run this file there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.ops import density, filter_scan, zscan
from geomesa_tpu_torch.ops.scan import stage_columns

torch.set_num_threads(2)  # xdist workers share the host's cores

pytestmark = pytest.mark.cuda

MAXI = (1 << 21) - 1
SENT = 0xFFFFFFFF
T0 = 1_577_836_800_000




def _load_chip_smoke():
    """``chip_smoke.py`` at the repo's root (importing it runs nothing):
    the batched-scan tests use its case generators, ``batch_qmat`` and
    ``batch_zbounds``, so that the card's end-to-end check and these tests
    draw their cases from one copy."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CASES = _load_chip_smoke()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


def _u32(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)).to(dev)


@pytest.mark.parametrize("n", [1, 3, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("r", [0, 1, 2, 4, 8])
def test_dimscan_kernel_matches_plain(dev, n, r):
    rng = np.random.default_rng(n + r)
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    bt = rng.integers(0, 8 << 21, n).astype(np.uint32)
    bt[: min(n, 2)] = SENT
    nx[-1:] = MAXI
    q = np.empty(4 + 2 * r, np.uint32)
    q[:4] = [0, MAXI, 1000, MAXI]
    for k in range(r):
        a, b = np.sort(rng.integers(0, 8 << 21, 2))
        q[4 + 2 * k: 6 + 2 * k] = (SENT, 0) if k == 1 else (a, b)
    planes = [_u32(nx, dev), _u32(ny, dev)] + ([_u32(bt, dev)] if r else [])
    before = dict(kernels.LAUNCHES)
    got_c = zscan.dimscan_count(q, *planes)
    got_m = zscan.dimscan_mask(q, *planes)
    want = zscan.dimscan_plain(q, *planes)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want)
    assert int(got_c) == int(want.sum())
    z = "z3" if r else "z2"
    assert kernels.LAUNCHES[f"dimscan_{z}_count"] == before[f"dimscan_{z}_count"] + 1
    assert kernels.LAUNCHES[f"dimscan_{z}_mask"] == before[f"dimscan_{z}_mask"] + 1


def _ring(k, cx=10.0, cy=20.0, r=15.0):
    a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    pts = [(cx + r * np.cos(t) * (1.0 + 0.3 * (i % 3)), cy + r * np.sin(t))
           for i, t in enumerate(a)]
    pts.append(pts[0])
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


W32 = 1 << 32
FILTERS = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "DWITHIN(geom, POINT(5 45), 1000, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0)))",
    f"DISJOINT(geom, POLYGON(({_ring(64)})))",
    "count > 50.5 AND count <> 70",
    "count IN (1, 2, 3, 42)",
    "NOT (count < 20 OR BBOX(geom, 0, 0, 90, 45))",
    f"dtg BETWEEN {W32 - 1} AND {2 * W32}",
]


@pytest.fixture(scope="module")
def batch():
    sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
    n = (1 << 18) + 13
    rng = np.random.default_rng(4)
    dtg = rng.integers(T0, T0 + 60 * 86400_000, n)
    dtg[:6] = [W32 - 1, W32, W32 + 1, 2 * W32, -W32, -1]
    xy = rng.uniform(-60, 60, (n, 2)).astype(np.float32).astype(np.float64)
    return FeatureBatch.from_columns(
        sft, {"count": rng.integers(0, 100, n), "dtg": dtg, "geom": xy}
    )


@pytest.mark.parametrize("ecql", FILTERS, ids=lambda s: s[:40])
def test_filter_scan_kernel_matches_plain(dev, batch, ecql):
    cf = compile_filter(parse_ecql(ecql), batch.sft)
    assert cf.program is not None
    cols = stage_columns(batch, cf.device_cols, dev)
    before = kernels.LAUNCHES["filter_scan_count"]
    got_c = cf.count(cols)
    got_m = cf.mask(cols)
    want = filter_scan.run_program_plain(cf.program, cols)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want)
    assert int(got_c) == int(want.sum())
    assert kernels.LAUNCHES["filter_scan_count"] == before + 1


POLY_SPEC = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"
ENV_BOX = (-10.0, 35.0, 30.0, 60.0)
ENV_FILTERS = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "DWITHIN(geom, POINT(5 45), 500, kilometers)",
    "DWITHIN(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)), 50, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    "NOT (count < 200 OR BBOX(geom, -10, 35, 30, 60)) OR dtg > '2020-02-20T00:00:00Z'",
]


def envelope_planes(n, seed, box=ENV_BOX):
    """Float32 envelope planes of n synthetic footprints around ``box``,
    the first rows with an edge exactly on a box edge or one float32 ulp
    inside or outside it, plus count and dtg planes."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(box[0] - 20, box[2] + 10, n).astype(np.float32)
    y0 = rng.uniform(box[1] - 20, box[3] + 10, n).astype(np.float32)
    x1 = (x0 + rng.uniform(0, 3, n)).astype(np.float32)
    y1 = (y0 + rng.uniform(0, 3, n)).astype(np.float32)
    edges = []
    for v in box:
        f = np.float32(v)
        edges += [f, np.nextafter(f, np.float32(-1e9)), np.nextafter(f, np.float32(1e9))]
    cx, cy = np.float32((box[0] + box[2]) / 2), np.float32((box[1] + box[3]) / 2)
    for i, e in enumerate(edges[:n]):
        # row i: an envelope inside the box but for one edge on, just
        # inside or just outside a box edge (x1 at xmin, y1 at ymin, x0 at
        # xmax, y0 at ymax)
        x0[i], y0[i], x1[i], y1[i] = cx - 1, cy - 1, cx + 1, cy + 1
        k = i // 3
        lo_plane, hi_plane = ((x0, x1), (y0, y1), (x0, x1), (y0, y1))[k]
        if k < 2:
            hi_plane[i], lo_plane[i] = e, e - np.float32(1)
        else:
            lo_plane[i], hi_plane[i] = e, e + np.float32(1)
    dtg = rng.integers(T0, T0 + 60 * 86400_000, n)
    hi, lo = (dtg >> 32).astype(np.int32), (dtg & 0xFFFFFFFF).astype(np.uint32)
    return {"geom__x0": x0, "geom__y0": y0, "geom__x1": x1, "geom__y1": y1,
            "count": rng.integers(0, 1000, n).astype(np.int32),
            "dtg__hi": hi, "dtg__lo": lo}


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("ecql", ENV_FILTERS, ids=lambda s: s[:40])
def test_filter_scan_envelope_planes_match_plain(dev, n, ecql):
    sft = SimpleFeatureType.create("p", POLY_SPEC)
    cf = compile_filter(parse_ecql(ecql), sft)
    assert cf.program is not None
    planes = envelope_planes(n, n)
    cols = {c: torch.from_numpy(planes[c]).to(dev) for c in cf.device_cols}
    want = filter_scan.run_program_plain(cf.program, cols)
    assert torch.equal(cf.mask(cols), want)
    assert int(cf.count(cols)) == int(want.sum())


# -- the staged filter scan: edges of its tiles, opcodes, layouts, threads ----

OPCODE_SPEC = "count:Int,score:Float,dtg:Date,*geom:Point:srid=4326"
OPCODE_FILTERS = [  # together they reach every opcode
    "BBOX(geom, -10, 35, 30, 60) OR DWITHIN(geom, POINT(5 45), 1000, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0))) AND NOT (score > 0.5)",
    f"INTERSECTS(geom, POLYGON(({_ring(64)})))",
    "DISJOINT(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0)))",
    "count = 7.5 OR count > 50",
    "count <> 12.5 AND dtg > '2020-02-01T00:00:00Z'",
]


def _point_planes(n, seed, dev, offset=0):
    """Float32 point, int32 count, float32 score and int64-lane dtg planes
    of n random rows on the card, each starting ``offset`` elements into
    its own allocation."""
    rng = np.random.default_rng(seed)
    dtg = rng.integers(T0, T0 + 60 * 86400_000, n)
    dtg[: min(n, 6)] = [W32 - 1, W32, W32 + 1, 2 * W32, -W32, -1][: min(n, 6)]
    host = {
        "geom__x": rng.uniform(-60, 60, n).astype(np.float32),
        "geom__y": rng.uniform(-60, 60, n).astype(np.float32),
        "count": rng.integers(0, 100, n).astype(np.int32),
        "score": rng.uniform(0, 1, n).astype(np.float32),
        "dtg__hi": (dtg >> 32).astype(np.int32),
        "dtg__lo": (dtg & 0xFFFFFFFF).astype(np.uint32),
    }
    out = {}
    for c, a in host.items():
        t = torch.from_numpy(a)
        buf = torch.empty(n + offset, dtype=t.dtype, device=dev)
        out[c] = buf[offset:]
        out[c].copy_(t)
    return out


def _check_scan(prog, cols, valid=None, what=""):
    """The kernel's count and mask against the plain version: the mask bit
    for bit, the count exactly, one launch each."""
    before = dict(kernels.LAUNCHES)
    got_m = filter_scan.filter_scan_mask(prog, cols, valid=valid)
    got_c = filter_scan.filter_scan_count(prog, cols, valid=valid)
    want = filter_scan.run_program_plain(prog, cols, valid=valid)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want), what
    assert got_c.dtype == torch.int32 and got_c.dim() == 0, what
    assert int(got_c) == int(want.sum()), what
    assert kernels.LAUNCHES["filter_scan_mask"] == before["filter_scan_mask"] + 1
    assert kernels.LAUNCHES["filter_scan_count"] == before["filter_scan_count"] + 1


def _tile_edges(prog, valid):
    """n at the edges of the kernel's tiles: 0, 1, 3, 4, 5, R - 1, R, R + 1
    and S * R + 5 for the count's and the mask's stage plans."""
    words = prog.instr.size + prog.consts.size
    ns = {0, 1, 3, 4, 5}
    for mask in (False, True):
        r, s, _ = filter_scan.stage_plan(len(prog.cols), words, valid, mask)
        ns |= {r - 1, r, r + 1, s * r + 5}
    return sorted(ns)


@pytest.mark.parametrize("valid", [False, True], ids=["no plane", "plane"])
@pytest.mark.parametrize("ecql", [
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "count > 50",
], ids=["bbox+during", "one compare"])
def test_filter_scan_tile_edges_match_plain(dev, ecql, valid):
    """Counts and masks at every n around the kernel's tiles and stages, and
    at 2^20 + 3 rows, with and without a validity plane (random, half live)."""
    prog = compile_filter(parse_ecql(ecql), SimpleFeatureType.create("t", OPCODE_SPEC)).program
    for n in _tile_edges(prog, valid) + [(1 << 20) + 3]:
        planes = _point_planes(n, n, dev)
        cols = {c: planes[c] for c in prog.cols}
        v = None
        if valid:
            v = torch.from_numpy(np.random.default_rng(n).random(n) < 0.5).to(dev)
        _check_scan(prog, cols, v, f"n={n}")


def test_filter_scan_every_opcode_matches_plain(dev):
    sft = SimpleFeatureType.create("t", OPCODE_SPEC)
    planes = _point_planes((1 << 16) + 7, 11, dev)
    seen = set()
    for ecql in OPCODE_FILTERS:
        prog = compile_filter(parse_ecql(ecql), sft).program
        assert prog is not None, ecql
        seen |= set(prog.instr[:, 0].tolist())
        _check_scan(prog, {c: planes[c] for c in prog.cols}, what=ecql)
    poly = compile_filter(parse_ecql(ENV_FILTERS[0]), SimpleFeatureType.create("p", POLY_SPEC)).program
    seen |= set(poly.instr[:, 0].tolist())
    env = envelope_planes((1 << 16) + 7, 3)
    _check_scan(poly, {c: torch.from_numpy(env[c]).to(dev) for c in poly.cols}, what="envelope")
    assert seen == set(range(12))


def _wide_program(n_cols=64, words=filter_scan.MAX_PROGRAM_WORDS):
    """A legal program of ``n_cols`` int32 columns and ``words`` words: one
    compare a column, folded by alternating AND and OR, one NOT, and the
    constant table padded to the word limit."""
    instr = []
    for i in range(n_cols):
        instr.append([filter_scan.OP_CMP_I32, i, 0, 0, 0, i, 0, 2 + i % 4])
        if i:
            instr.append([filter_scan.OP_AND if i % 2 else filter_scan.OP_OR] + [0] * 7)
    instr.append([filter_scan.OP_NOT] + [0] * 7)
    instr = np.array(instr, np.int32)
    consts = np.zeros(words - instr.size, np.uint32)
    consts[:n_cols] = (np.arange(n_cols) * 37) % 100
    return filter_scan.Program(
        cols=[f"c{i}" for i in range(n_cols)], col_dtypes=[torch.int32] * n_cols,
        instr=instr, consts=consts, depth=2)


@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 3])
@pytest.mark.parametrize("valid", [False, True], ids=["no plane", "plane"])
def test_filter_scan_widest_program_matches_plain(dev, n, valid):
    """64 columns and 12288 words, the largest program the encoder
    accepts: the kernel still launches (fewer rows a stage) and agrees."""
    prog = _wide_program()
    assert prog.instr.size + prog.consts.size == filter_scan.MAX_PROGRAM_WORDS
    rng = np.random.default_rng(n)
    cols = {c: torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)).to(dev)
            for c in prog.cols}
    v = torch.from_numpy(rng.random(n) < 0.5).to(dev) if valid else None
    _check_scan(prog, cols, v, f"n={n}")


@pytest.mark.parametrize("op", ["INTERSECTS", "DISJOINT"])
def test_filter_scan_64_edge_polygon_matches_plain(dev, op):
    prog = compile_filter(parse_ecql(f"{op}(geom, POLYGON(({_ring(64)})))"),
                          SimpleFeatureType.create("t", OPCODE_SPEC)).program
    assert int(prog.instr[0, 6]) == 64
    planes = _point_planes((1 << 20) + 3, 64, dev)
    _check_scan(prog, {c: planes[c] for c in prog.cols})


@pytest.mark.parametrize("offset", [4, 12, 36])
def test_filter_scan_planes_off_128_bytes_match_plain(dev, offset):
    """Planes 16-byte aligned but not 128-byte aligned (4, 12 and 36
    elements into their allocations), and validity planes at 4-, 8- and
    12-byte offsets from 16 bytes."""
    prog = compile_filter(parse_ecql(OPCODE_FILTERS[0] + " AND count > 20"),
                          SimpleFeatureType.create("t", OPCODE_SPEC)).program
    n = (1 << 18) + 5
    planes = _point_planes(n, offset, dev, offset=offset)
    cols = {c: planes[c] for c in prog.cols}
    assert all(t.data_ptr() % 16 == 0 and t.data_ptr() % 128 for t in cols.values())
    _check_scan(prog, cols, what=f"offset {offset}")
    live = torch.from_numpy(np.random.default_rng(offset).random(n + 16) < 0.5).to(dev)
    for k in (0, 4, 8, 12):
        v = live[k:k + n]
        assert v.data_ptr() % 16 == k
        _check_scan(prog, cols, v, f"offset {offset}, validity at +{k}")


def test_filter_scan_misaligned_planes_raise(dev):
    prog = compile_filter(parse_ecql("count > 50"), SimpleFeatureType.create("t", OPCODE_SPEC)).program
    t = torch.zeros(65, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        filter_scan.filter_scan_mask(prog, {"count": t[1:]})
    assert int(filter_scan.filter_scan_count(prog, {"count": t[4:]})) == 0
    with pytest.raises(ValueError, match="4-byte aligned"):
        filter_scan.filter_scan_count(prog, {"count": t[4:]},
                                      valid=torch.ones(62, dtype=torch.bool, device=dev)[1:])


def test_filter_scan_eight_threads_on_one_index(dev):
    """8 threads count and mask over one program's planes at once, as the
    scheduler's workers do: they share one launch record, and every answer
    equals the plain version."""
    import threading

    prog = compile_filter(parse_ecql(FILTERS[1]), SimpleFeatureType.create("t", OPCODE_SPEC)).program
    planes = _point_planes((1 << 20) + 3, 8, dev)
    cols = {c: planes[c] for c in prog.cols}
    want = filter_scan.run_program_plain(prog, cols)
    want_c = int(want.sum())
    bad, start = [], threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(25):
            m = filter_scan.filter_scan_mask(prog, cols)
            c = filter_scan.filter_scan_count(prog, cols)
            torch.cuda.current_stream().synchronize()
            if not torch.equal(m, want) or int(c) != want_c:
                bad.append(1)

    before = dict(kernels.LAUNCHES)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    assert len(prog._records) == 1
    assert kernels.LAUNCHES["filter_scan_mask"] == before["filter_scan_mask"] + 200
    assert kernels.LAUNCHES["filter_scan_count"] == before["filter_scan_count"] + 200


# -- interleaved masked-compare scan and baked dim scan ---------------------


def zscan_case(n, n_bins, seed):
    """Interleaved Z3 keys of random points over bins 2600..2600+n_bins-1
    (a few rows in bin -1, which padded entries must not match), and for
    Z2 the keys of the same points."""
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.curves.zorder import u64_hi_lo

    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    off = rng.uniform(0, 604_800, n)
    if n >= 4:
        x[:4], y[:4], off[:4] = [180, -180, 0, 5], [90, -90, 0, 5], [604_800, 0, 0, 302_400]
    bins = (2600 + rng.integers(0, n_bins, n)).astype(np.int32)
    bins[: min(n, 3)] = -1
    h3, l3 = u64_hi_lo(Z3SFC().index(x, y, off))
    h2, l2 = u64_hi_lo(Z2SFC().index(x, y))
    return rng, bins, (h3, l3), (h2, l2)


def zscan_bounds(rng, n_bins, b, random_words):
    """(bounds, ids) with b entries over bins 2600.. : cell boxes from the
    curve's own bounds, or random words; some ids padded (-1)."""
    if random_words:
        bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
    else:
        bounds = np.stack([
            zscan.z3_dim_bounds(tuple(lo), tuple(hi)) for lo, hi in (
                np.sort(rng.integers(0, MAXI + 1, (2, 3)), axis=0) for _ in range(b))
        ])
    ids = (2600 + rng.permutation(max(n_bins, b))[:b]).astype(np.int32)
    ids[rng.random(b) < 0.25] = -1
    return bounds, ids


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("b", [1, 2, 7, 28, 64])
@pytest.mark.parametrize("random_words", [False, True], ids=["cells", "random"])
def test_zscan_z3_kernel_matches_plain(dev, n, b, random_words):
    rng, bins, (h3, l3), _ = zscan_case(n, 64, seed=n + b)
    bounds, ids = zscan_bounds(rng, 64, b, random_words)
    planes = (torch.from_numpy(bins).to(dev), _u32(h3, dev), _u32(l3, dev))
    for bb, ii in ((bounds, ids), (bounds, np.full(b, -1, np.int32))):  # and all padded
        count_fn, mask_fn = zscan.build_z3_pallas_scan(bb, ii)
        before = dict(kernels.LAUNCHES)
        got_c, got_m = count_fn(*planes), mask_fn(*planes)
        want = zscan.z3_zscan_mask(planes[1], planes[2], planes[0], bb, ii)
        torch.cuda.synchronize()
        assert got_m.dtype == torch.bool and torch.equal(got_m, want)
        assert got_c.dtype == torch.int32 and int(got_c) == int(want.sum())
        assert kernels.LAUNCHES["zscan_z3_count"] == before["zscan_z3_count"] + 1
        assert kernels.LAUNCHES["zscan_z3_mask"] == before["zscan_z3_mask"] + 1
        if (ii < 0).all():
            assert int(got_c) == 0


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("random_words", [False, True], ids=["cells", "random"])
def test_zscan_z2_kernel_matches_plain(dev, n, random_words):
    from geomesa_tpu_torch.curves.zorder import MAX_MASK_2D

    rng, _, _, (h2, l2) = zscan_case(n, 4, seed=n + 5)
    planes = (_u32(h2, dev), _u32(l2, dev))
    for _ in range(4):
        if random_words:
            bounds = rng.integers(0, 1 << 32, (2, 6), dtype=np.uint64).astype(np.uint32)
        else:
            lo, hi = np.sort(rng.integers(0, MAX_MASK_2D + 1, (2, 2)), axis=0)
            bounds = zscan.z2_dim_bounds(tuple(lo), tuple(hi))
        count_fn, mask_fn = zscan.build_z2_zscan(bounds)
        got_c, got_m = count_fn(*planes), mask_fn(*planes)
        want = zscan.z2_zscan_mask(*planes, bounds)
        torch.cuda.synchronize()
        assert torch.equal(got_m, want) and int(got_c) == int(want.sum())


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("r", [0, 1, 2, 5, 16, 300])
def test_baked_dimscan_kernel_matches_plain(dev, n, r):
    rng = np.random.default_rng(n + 31 * r)
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    bt = rng.integers(0, 40 << 21, n).astype(np.uint32)
    bt[: min(n, 2)] = SENT
    nx[-1:] = MAXI
    qnx = tuple(np.sort(rng.integers(0, MAXI + 1, 2)))
    qny = (0, MAXI)
    ranges = [tuple(np.sort(rng.integers(0, 40 << 21, 2))) for _ in range(r)]
    if r > 1:
        ranges[1] = (SENT, 0)  # inverted: never matches
    planes = [_u32(a, dev) for a in (nx, ny, bt)]
    count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
    before = dict(kernels.LAUNCHES)
    got_c, got_m = count_fn(*planes), mask_fn(*planes)
    want = zscan.z3_dimscan_mask(*planes, qnx, qny, ranges)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want) and int(got_c) == int(want.sum())
    assert kernels.LAUNCHES["dimscan_baked_count"] == before["dimscan_baked_count"] + 1
    assert kernels.LAUNCHES["dimscan_baked_mask"] == before["dimscan_baked_mask"] + 1


def test_baked_dimscan_agrees_with_the_runtime_kernel(dev):
    """The two dim-scan engines on one window: the runtime query vector of
    the dim scan and the baked query of the same bins."""
    from geomesa_tpu_torch.curves.z3 import Z3SFC

    rng = np.random.default_rng(12)
    n = (1 << 20) + 3
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    bt = ((rng.integers(0, 9, n).astype(np.uint32) << np.uint32(21))
          | rng.integers(0, MAXI + 1, n).astype(np.uint32))
    planes = [_u32(a, dev) for a in (nx, ny, bt)]
    sfc, base = Z3SFC(), 2608
    for env, w in (((-10.0, 35.0, 30.0, 60.0), (T0 + 9 * 86400_000, T0 + 14 * 86400_000)),
                   ((-180.0, -90.0, 180.0, 90.0), (T0, T0 + 59 * 86400_000))):
        qarr, _ = zscan.z3_dim_plane_qarr(sfc, env, w, base, None)
        qnx, qny, ranges = zscan.z3_dim_plane_query(sfc, *env, *w, base)
        count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
        assert torch.equal(mask_fn(*planes), zscan.dimscan_mask(qarr, *planes))
        assert int(count_fn(*planes)) == int(zscan.dimscan_count(qarr, *planes)) > 0


def test_misaligned_planes_raise(dev):
    t = torch.zeros(65, dtype=torch.uint32, device=dev)
    q = np.array([0, 1, 0, 1], np.uint32)
    with pytest.raises(ValueError, match="aligned"):
        zscan.dimscan_count(q, t[1:], t[1:])
    count_fn, _ = zscan.build_z2_zscan(np.zeros((2, 6), np.uint32))
    with pytest.raises(ValueError, match="aligned"):
        count_fn(t[1:], t[1:])


# -- density ------------------------------------------------------------------

DENSITY_ENV = (-60.0, -45.0, 100.0, 60.0)
GRIDS = [(16, 16), (100, 37), (256, 256), (512, 512), (1024, 1024), (2048, 1024)]


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


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("wh", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("clustered", [True, False], ids=["clustered", "uniform"])
def test_density_kernel_matches_plain(dev, n, wh, clustered):
    width, height = wh
    x, y, m, w = (torch.from_numpy(a).to(dev)
                  for a in density_case(n, width, height, clustered, seed=n + width))
    for mask in (None, m):
        before = dict(kernels.LAUNCHES)
        got = density.density_grid(x, y, DENSITY_ENV, width, height, mask=mask)
        want = density.density_plain(x, y, DENSITY_ENV, width, height, mask=mask)
        got_w = density.density_grid(x, y, DENSITY_ENV, width, height, mask=mask, weights=w)
        want_w = density.density_plain(x, y, DENSITY_ENV, width, height, mask=mask, weights=w)
        # the hot-cell engine on every grid, also those the cluster engine takes
        got_g = density._launch(x, y, DENSITY_ENV, width, height, mask, None, engine=("hotcell", 0))
        torch.cuda.synchronize()
        assert got.shape == (height, width) and torch.equal(got, want)
        assert torch.equal(got_g, want)
        torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=0.0)
        # 0 rows launch nothing: the grid stays zero
        assert kernels.LAUNCHES["density_count"] == before["density_count"] + (2 if n else 0)
        assert kernels.LAUNCHES["density_weighted"] == before["density_weighted"] + (1 if n else 0)


def test_device_index_density_on_the_card_matches_the_host(dev):
    """The resident path end to end: the mask kernel, then the density
    kernel, against the same index on the CPU (plain versions)."""
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN
    from geomesa_tpu_torch.store.direct import BatchStore

    sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
    n = 50_000
    x, y, _, _ = density_case(n, 256, 256, True, seed=9)
    rng = np.random.default_rng(9)
    cols = {"count": rng.integers(0, 100, n), "dtg": rng.integers(T0, T0 + 60 * 86400_000, n),
            "geom": np.stack([x, y], axis=1).astype(np.float64),
            VIS_COLUMN: rng.choice(["", "A", "A&B"], n)}
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    gpu = DeviceIndex(store, "t", z_planes=True, device=dev)
    cpu = DeviceIndex(store, "t", z_planes=True, device="cpu")
    q = "BBOX(geom, -30, -20, 60, 40) AND dtg DURING 2020-01-05T00:00:00Z/2020-02-01T00:00:00Z"
    for f, loose in ((q, False), (q, True), ("INCLUDE", None)):
        for auths in (None, ("A",), ("A", "B")):
            before = dict(kernels.LAUNCHES)
            got = gpu.density(f, DENSITY_ENV, 512, 256, loose=loose, auths=auths)
            np.testing.assert_array_equal(
                got, cpu.density(f, DENSITY_ENV, 512, 256, loose=loose, auths=auths))
            assert kernels.LAUNCHES["density_count"] == before["density_count"] + 1
            assert gpu.count(f, loose=loose, auths=auths) == cpu.count(f, loose=loose, auths=auths)


ENGINES = [("cluster", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8), ("hotcell", 0)]
LINES_ENV = (-20.0, 10.0, -20.0, 40.0)  # zero width: rows on x = -20 count in column 0


@pytest.mark.parametrize("n", [1000, (1 << 20) + 17])
@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: f"{e[0]}{e[1] or ''}")
@pytest.mark.parametrize("clustered", [True, False], ids=["clustered", "uniform"])
def test_density_engines_match_plain(dev, n, engine, clustered):
    """Every engine, forced, on every grid it can hold: counts exact,
    weights (hot-cell engine) within rtol 1e-6; and on a
    zero-width viewport with rows on its line."""
    kind, c = engine
    for width, height in GRIDS + [(1, 1)]:
        cells = width * height
        if kind == "cluster" and cells > (1 << 15) * c:
            continue
        x, y, m, w = (torch.from_numpy(a).to(dev)
                      for a in density_case(n, width, height, clustered, seed=n + width + 1))
        for mask in (None, m):
            got = density._launch(x, y, DENSITY_ENV, width, height, mask, None, engine=engine)
            want = density.density_plain(x, y, DENSITY_ENV, width, height, mask=mask)
            assert torch.equal(got, want), (width, height)
            if kind != "cluster":
                got_w = density._launch(x, y, DENSITY_ENV, width, height, mask, w, engine=engine)
                want_w = density.density_plain(x, y, DENSITY_ENV, width, height, mask=mask, weights=w)
                torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=0.0)
    x, y, m, w = (torch.from_numpy(a).to(dev) for a in density_case(n, 64, 64, clustered, seed=n))
    x[: n // 3] = LINES_ENV[0]
    y[: n // 3] = torch.linspace(0.0, 50.0, n // 3, device=dev)
    for mask in (None, m):
        got = density._launch(x, y, LINES_ENV, 64, 64, mask, None, engine=engine, lines=True)
        want = density.density_plain(x, y, LINES_ENV, 64, 64, mask=mask, lines=True)
        assert torch.equal(got, want) and int(got.sum()) > 0 and not got[:, 1:].any()


def test_density_static_engines_and_refusals(dev):
    assert density.engine_for(128, 128, False) == ("cluster", 1)
    assert density.engine_for(256, 256, False) == ("cluster", 2)
    assert density.engine_for(512, 256, False) == ("cluster", 4)
    assert density.engine_for(512, 512, False) == ("cluster", 8)
    assert density.engine_for(1024, 1024, False) == ("hotcell", 0)
    assert density.engine_for(128, 128, True) == ("hotcell", 0)
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="cannot take a counted 512x512"):
        density._launch(x, x, DENSITY_ENV, 512, 512, None, None, engine=("cluster", 4))
    with pytest.raises(ValueError, match="cannot take a weighted"):
        density._launch(x, x, DENSITY_ENV, 64, 64, None, x, engine=("cluster", 1))
    assert density.engines(512, 512, False)[0] == ("cluster", 8)
    assert density.engines(128, 128, True) == [("hotcell", 0)]


def test_device_index_density_degenerate_viewports_on_the_card(dev):
    """An inverted viewport answers a zero grid with no launch; a
    zero-width one counts the rows on its line, as the CPU index does."""
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.store.direct import BatchStore

    sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
    n = 20_000
    x, y, _, _ = density_case(n, 64, 64, True, seed=4)
    x[:500] = 0.0
    rng = np.random.default_rng(4)
    cols = {"count": rng.integers(0, 100, n), "dtg": rng.integers(T0, T0 + 60 * 86400_000, n),
            "geom": np.stack([x, y], axis=1).astype(np.float64)}
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    gpu = DeviceIndex(store, "t", z_planes=True, device=dev)
    cpu = DeviceIndex(store, "t", z_planes=True, device="cpu")
    for env in ((170, -10, -170, 10), (0, -40, 0, 40), (-60, 0, 60, 0), (0, 0, 0, 0)):
        for weight in (None, "count"):
            kernels.reset_counts()
            got = gpu.density("INCLUDE", Envelope(*env), 300, 200, weight_attr=weight)
            want = cpu.density("INCLUDE", Envelope(*env), 300, 200, weight_attr=weight)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
            launched = sum(kernels.LAUNCHES.values())
            assert launched == (0 if env[0] > env[2] else 1)


@pytest.mark.parametrize("n", [1000, (1 << 20) + 17])
@pytest.mark.parametrize("b", [1, 2, 29, 64])
@pytest.mark.parametrize("layout", ["contiguous", "gapped", "padded"])
def test_zscan_z3_many_bins_matches_plain(dev, n, b, layout):
    """The bin lookup over 1 to 64 bins: contiguous ids, ids with gaps
    (bins between entries have none), and ids padded to a power of two."""
    rng, bins, (h3, l3), _ = zscan_case(n, 128, seed=n + 3 * b)
    bounds = np.stack([
        zscan.z3_dim_bounds(tuple(lo), tuple(hi)) for lo, hi in (
            np.sort(rng.integers(0, MAXI + 1, (2, 3)), axis=0) for _ in range(b))
    ])
    if layout == "gapped":
        ids = (2600 + np.sort(rng.permutation(128)[:b])).astype(np.int32)
    else:
        ids = (2600 + 10 + np.arange(b)).astype(np.int32)
    if layout == "padded":
        bounds, ids = zscan.pad_bins(bounds, ids)
    planes = (torch.from_numpy(bins).to(dev), _u32(h3, dev), _u32(l3, dev))
    count_fn, mask_fn = zscan.build_z3_pallas_scan(bounds, ids)
    got_c, got_m = count_fn(*planes), mask_fn(*planes)
    want = zscan.z3_zscan_mask(planes[1], planes[2], planes[0], bounds, ids)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want) and int(got_c) == int(want.sum())


# -- the Q-batched scans of the scheduler's fused loose paths ---------------


@pytest.mark.parametrize("n", [0, 1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("nq", [1, 3, 8, 64])
@pytest.mark.parametrize("r", [0, 1, 2, 4, 8])
def test_batched_dimscan_kernel_matches_plain(dev, n, nq, r):
    rng = np.random.default_rng(7 * n + 11 * nq + r)
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    bt = rng.integers(0, 8 << 21, n).astype(np.uint32)
    bt[: min(n, 2)] = SENT
    nx[-1:] = MAXI
    qmat = _CASES.batch_qmat(rng, nq, r, 8 << 21)
    planes = [_u32(nx, dev), _u32(ny, dev)] + ([_u32(bt, dev)] if r else [])
    z = "z3" if r else "z2"
    before = dict(kernels.LAUNCHES)
    got_c = zscan.batched_dimscan_count(qmat, *planes)
    got_m = zscan.batched_dimscan_mask(qmat, *planes)
    want = zscan.batched_dim_mask_rt(r)(*planes, qmat)
    torch.cuda.synchronize()
    assert got_m.shape == (nq, n) and got_m.dtype == torch.bool and torch.equal(got_m, want)
    assert got_c.dtype == torch.int32 and torch.equal(got_c, want.sum(dim=1, dtype=torch.int32))
    # each row equals the single-query kernel's mask
    for i in range(nq):
        assert torch.equal(got_m[i], zscan.dimscan_mask(qmat[i], *planes))
    if nq > 2:
        assert int(got_c[-1]) == 0
    assert kernels.LAUNCHES[f"dimscan_batched_{z}_count"] == before[f"dimscan_batched_{z}_count"] + 1
    assert kernels.LAUNCHES[f"dimscan_batched_{z}_mask"] == before[f"dimscan_batched_{z}_mask"] + 1
    for compare in (True, False):  # each way, whatever the shape picks
        pk = zscan.batched_dimscan(qmat, compare=compare)
        assert torch.equal(pk.run(planes, True), want)
        assert torch.equal(pk.run(planes, False), want.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 1003, (1 << 20) + 3])
@pytest.mark.parametrize("nq", [1, 3, 64])
@pytest.mark.parametrize("r", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("edge", _CASES.BATCH_EDGES)
def test_batched_dimscan_kernel_edge_groups(dev, n, nq, r, edge):
    """The batched dim scan's interval lookup on the edge groups of
    ``chip_smoke.py`` (ranges at 0 and 0xFFFFFFFF, identical queries,
    nested ranges and shared ends, adjacent and overlapping bt ranges, all
    padding) over rows at the groups' range ends and one either side,
    without and with a validity plane, through the wrappers and with each
    of the kernel's two ways forced; the plain version on the packed layout
    gives the same masks."""
    rng = np.random.default_rng(13 * n + 7 * nq + r + 100 * _CASES.BATCH_EDGES.index(edge))
    qmat = _CASES.batch_qmat_edge(rng, edge, nq, r, 8 << 21)
    planes = [_u32(a, dev) for a in _CASES.batch_edge_planes(rng, qmat, n)]
    half = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    for v in (None, half):
        want = zscan.batched_dim_mask_rt(r)(*planes, qmat, valid=v)
        got_m = zscan.batched_dimscan_mask(qmat, *planes, valid=v)
        got_c = zscan.batched_dimscan_count(qmat, *planes, valid=v)
        torch.cuda.synchronize()
        assert torch.equal(got_m, want)
        assert torch.equal(got_c, want.sum(dim=1, dtype=torch.int32))
        for compare in (True, False):  # each way, whatever the shape picks
            pk = zscan.batched_dimscan(qmat, compare=compare)
            assert torch.equal(pk.run(planes, True, valid=v), want)
            assert torch.equal(pk.run(planes, False, valid=v), want.sum(dim=1, dtype=torch.int32))
    assert torch.equal(zscan.batched_dimscan(qmat).plain(*planes),
                       zscan.batched_dim_mask_rt(r)(*planes, qmat))


def test_batched_dimscan_entry_refuses_what_it_cannot_take(dev):
    """The lookup way's C entry point refuses a table whose size does not
    match its depths, a depth past 11, a z2 launch with a bt depth and 65
    queries; the compare way's refuses 65 queries and R = 3."""
    from geomesa_tpu_torch.kernels import _build

    rng = np.random.default_rng(5)
    qmat = _CASES.batch_qmat(rng, 4, 1, 8 << 21)
    pk = zscan.batched_dimscan(qmat, compare=False)
    planes = [_u32(rng.integers(0, MAXI, 64), dev) for _ in range(3)]
    tab = pk.device_table(dev)
    out = torch.empty(4, dtype=torch.int32, device=dev)
    fn = _build.load("dimscan").gm_dimscan_batched
    stream = torch.cuda.current_stream(dev).cuda_stream
    good = [len(pk.lookup_table), 4, 3, *pk.depths]
    for words, nq, dims, dx, dy, dt in (
            [good[0] + 4] + good[1:], good[:3] + [12] + good[4:],
            [good[0], 4, 2] + good[3:], [good[0], 65, 3] + good[3:]):
        rc = fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), None, 64,
                tab.data_ptr(), words, nq, dims, dx, dy, dt, 0, out.data_ptr(), stream)
        assert rc != 0
    rc = fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), None, 64,
            tab.data_ptr(), *good, 0, out.data_ptr(), stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(out, zscan.batched_dim_mask_rt(1)(*planes, qmat).sum(dim=1, dtype=torch.int32))
    cmp_fn = _build.load("dimscan").gm_dimscan_batched_compare
    qdev = zscan.batched_dimscan(qmat, compare=True).device_table(dev, want_mask=False)
    for nq, r in ((65, 1), (4, 3)):
        assert cmp_fn(planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(), None, 64,
                      qdev.data_ptr(), nq, r, 0, out.data_ptr(), stream) != 0


def _batched_launches(name, run):
    """Run ``run()`` and return the launches of kernel ``name`` it made and
    the widths (queries) they carried."""
    before = kernels.LAUNCHES[name]
    widths = dict(kernels.BATCH_WIDTHS[name])
    out = run()
    after = kernels.BATCH_WIDTHS[name]
    grew = {q: after[q] - widths.get(q, 0) for q in after if after[q] != widths.get(q, 0)}
    return out, kernels.LAUNCHES[name] - before, grew


def _ordered(bounds):
    """Random-word bounds with lo <= hi in every dimension (swapped where
    not), so that no entry drops out as empty."""
    lo, hi = bounds[..., 2:4].copy(), bounds[..., 4:6].copy()
    swap = (lo[..., 0] > hi[..., 0]) | ((lo[..., 0] == hi[..., 0]) & (lo[..., 1] > hi[..., 1]))
    bounds[..., 2:4] = np.where(swap[..., None], hi, lo)
    bounds[..., 4:6] = np.where(swap[..., None], lo, hi)
    return bounds


def _check_batched_zscan(pk, planes, b, want):
    """The kernel's count and mask for packed group ``pk`` equal ``want``
    (the semantic reference) and the plain version on the packed layout,
    bit for bit; one launch per packed table, each with its queries."""
    z = f"z{pk.n_dims}"
    got_c, nc, wc = _batched_launches(f"zscan_batched_{z}_count",
                                      lambda: pk.run(b, *planes, want_mask=False))
    got_m, nm, wm = _batched_launches(f"zscan_batched_{z}_mask",
                                      lambda: pk.run(b, *planes, want_mask=True))
    torch.cuda.synchronize()
    n = planes[0].shape[0]
    assert got_m.shape == (pk.nq, n) and got_m.dtype == torch.bool and torch.equal(got_m, want)
    assert got_c.dtype == torch.int32 and torch.equal(got_c, want.sum(dim=1, dtype=torch.int32))
    assert torch.equal(pk.plain(b, *planes), want)
    widths = {}
    for lc in pk.launches:
        widths[lc.q1 - lc.q0] = widths.get(lc.q1 - lc.q0, 0) + 1
    assert nc == nm == len(pk.launches) and wc == wm == widths


@pytest.mark.parametrize("n", [0, 1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("nq", [1, 3, 8, 47, 64])
def test_batched_zscan_z3_kernel_matches_plain(dev, n, nq):
    rng, bins, (h3, l3), _ = zscan_case(n, 16, seed=3 * n + nq)
    bounds, ids = _CASES.batch_zbounds(rng, nq, 16)
    planes = (_u32(h3, dev), _u32(l3, dev))
    b = torch.from_numpy(bins).to(dev)
    want = zscan.batched_kind_mask("z3")(*planes, b, bounds, ids)
    _check_batched_zscan(zscan.batched_zscan(bounds, ids), planes, b, want)
    got_c = zscan.batched_zscan_count(bounds, ids, *planes, bins=b)
    got_m = zscan.batched_zscan_mask(bounds, ids, *planes, bins=b)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want) and torch.equal(got_c, want.sum(dim=1, dtype=torch.int32))
    for i in range(nq):  # each row equals the single-query kernel's mask
        assert torch.equal(got_m[i], zscan.build_z3_pallas_scan(bounds[i], ids[i])[1](b, *planes))
    if nq > 2:
        assert int(got_c[-1]) == 0


@pytest.mark.parametrize("n", [1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("form", ["compact", "masked", "mixed"])
@pytest.mark.parametrize("finding", ["flat", "binned"])
def test_batched_zscan_z3_entry_forms(dev, n, form, finding):
    """Both record forms (cell boxes compact, random words masked, and
    both in one group) under both ways of finding a row's records: every
    record per row (at most FLAT_MAX_RECORDS of them; the flat group's two
    queries share their bins, so its cell boxes pack compact) and the bin
    index."""
    rng, bins, (h3, l3), _ = zscan_case(n, 16, seed=n + len(form) + len(finding))
    nq, per = (2, 2) if finding == "flat" else (13, 6)
    bounds = np.empty((nq, per, 3, 6), np.uint32)
    for q in range(nq):
        cells = form == "compact" or (form == "mixed" and q % 2 == 0)
        bounds[q] = _ordered(zscan_bounds(rng, 16, per, random_words=not cells)[0])
    ids = np.stack([(2600 + rng.permutation(16)[:per]).astype(np.int32) for _ in range(nq)])
    if finding == "flat":
        ids[1] = ids[0]
    pk = zscan.batched_zscan(bounds, ids)
    assert [lc.binned for lc in pk.launches] == [finding == "binned"]
    assert (pk.launches[0].nc > 0, pk.launches[0].nm > 0) == (form != "masked", form != "compact")
    planes = (_u32(h3, dev), _u32(l3, dev))
    b = torch.from_numpy(bins).to(dev)
    _check_batched_zscan(pk, planes, b, zscan.batched_kind_mask("z3")(*planes, b, bounds, ids))


@pytest.mark.parametrize("n", [1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_batched_zscan_cell_boxes_one_a_bin_launch_masked(dev, n, n_dims):
    """Cell boxes that no row can meet two of (z2: one query; z3: one
    query's three bins) pack as masked records; the kernel equals the
    plain versions."""
    from geomesa_tpu_torch.curves.zorder import MAX_MASK_2D

    rng, bins, k3, k2 = zscan_case(n, 16, seed=7 * n + n_dims)
    planes = tuple(_u32(a, dev) for a in (k3 if n_dims == 3 else k2))
    if n_dims == 3:
        bounds = _ordered(zscan_bounds(rng, 16, 3, random_words=False)[0])[None]
        ids = (2600 + rng.permutation(16)[:3]).astype(np.int32)[None]
        b = torch.from_numpy(bins).to(dev)
        want = zscan.batched_kind_mask("z3")(*planes, b, bounds, ids)
    else:
        lo, hi = np.sort(rng.integers(0, MAX_MASK_2D + 1, (2, 2)), axis=0)
        bounds, ids, b = zscan.z2_dim_bounds(tuple(lo), tuple(hi))[None], None, None
        want = zscan.batched_kind_mask("z2")(*planes, bounds)
    pk = zscan.batched_zscan(bounds, ids)
    assert [(lc.nc, lc.nm) for lc in pk.launches] == [(0, 3 if n_dims == 3 else 1)]
    _check_batched_zscan(pk, planes, b, want)


def test_batched_zscan_z3_table_past_shared_memory(dev):
    """64 queries of 64 bins each: cell boxes, then random words, tables
    past one block's shared memory, which the wrapper splits by queries
    into several launches."""
    rng, bins, (h3, l3), _ = zscan_case((1 << 20) + 3, 128, seed=99)
    planes = (_u32(h3, dev), _u32(l3, dev))
    b = torch.from_numpy(bins).to(dev)
    ids = np.stack([(2600 + rng.permutation(128)[:64]).astype(np.int32) for _ in range(64)])
    for random_words in (False, True):
        bounds = _ordered(np.stack([zscan_bounds(rng, 128, 64, random_words=random_words)[0]
                                    for _ in range(64)]))
        pk = zscan.batched_zscan(bounds, ids)
        assert len(pk.launches) > 1 and all(lc.binned for lc in pk.launches)
        assert 4 * len(pk.table) > zscan.BATCH_TABLE_BYTES
        want = zscan.batched_kind_mask("z3")(*planes, b, bounds, ids)
        _check_batched_zscan(pk, planes, b, want)


@pytest.mark.parametrize("n", [0, 1, 5, (1 << 20) + 3])
@pytest.mark.parametrize("nq", [1, 3, 8, 47, 64])
def test_batched_zscan_z2_kernel_matches_plain(dev, n, nq):
    from geomesa_tpu_torch.curves.zorder import MAX_MASK_2D

    rng, _, _, (h2, l2) = zscan_case(n, 4, seed=5 * n + nq)
    bounds = np.empty((nq, 2, 6), np.uint32)
    for i in range(nq):
        if i % 2:
            bounds[i] = rng.integers(0, 1 << 32, (2, 6), dtype=np.uint64).astype(np.uint32)
        else:
            lo, hi = np.sort(rng.integers(0, MAX_MASK_2D + 1, (2, 2)), axis=0)
            bounds[i] = zscan.z2_dim_bounds(tuple(lo), tuple(hi))
    if nq > 2:
        bounds[-1] = 0
        bounds[-1, :, 3] = 1  # lo_lo 1 > hi 0: the fused paths' z2 padding
    planes = (_u32(h2, dev), _u32(l2, dev))
    want = zscan.batched_kind_mask("z2")(*planes, bounds)
    pk = zscan.batched_zscan(bounds, None)
    _check_batched_zscan(pk, planes, None, want)
    got_c = zscan.batched_zscan_count(bounds, None, *planes)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want.sum(dim=1, dtype=torch.int32))
    if nq > 2:
        assert int(got_c[-1]) == 0


def test_device_index_fused_paths_on_the_card(dev):
    """The fused loose paths of DeviceIndex on the card equal its serial
    loose answers, on dim planes and the interleaved layout, z3 and z2."""
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.store.direct import BatchStore

    rng = np.random.default_rng(4)
    n = 200_003
    xy = rng.uniform([-60, -40], [60, 40], (n, 2)).astype(np.float32).astype(np.float64)
    cols = {"dtg": rng.integers(T0, T0 + 30 * 86_400_000, n), "geom": xy}
    tiles = [f"BBOX(geom, {x}, {y}, {x + 4}, {y + 3})" for x, y in rng.uniform(-55, 35, (11, 2))]
    for spec, days in (("dtg:Date,*geom:Point:srid=4326", True), ("*geom:Point:srid=4326", False)):
        sft = SimpleFeatureType.create("t", spec)
        c = cols if days else {"geom": xy}
        qs = [t + (f" AND dtg DURING 2020-01-{3 + i:02d}T00:00:00Z/2020-01-{4 + i:02d}T06:00:00Z"
                   if days else "") for i, t in enumerate(tiles)]
        for dim in (None, False):
            di = DeviceIndex(BatchStore(FeatureBatch.from_columns(sft, c)), "t", z_planes=True,
                             dim_planes=dim, device=dev)
            assert di.fused_loose_counts(qs, loose=True) == [di.count(q, loose=True) for q in qs]
            for q, got in zip(qs, di.fused_loose_query(qs, loose=True)):
                np.testing.assert_array_equal(got.fids, di.query(q, loose=True).fids)


# -- the AIS processes' torch ops (no TPU kernel behind them): the card's
# answer equals the same functions on CPU tensors, bit for bit

def knn_case(n, seed):
    """float32 points around (10, 20) with exact duplicates at one distance
    and rows on the 0.5-degree radius box's edges and one ulp either side."""
    from geomesa_tpu_torch.ops import knn as knn_ops

    rng = np.random.default_rng(seed)
    x = rng.uniform(9.0, 11.0, n).astype(np.float32)
    y = rng.uniform(19.0, 21.0, n).astype(np.float32)
    if n >= 1000:
        x[100:140], y[100:140] = np.float32(10.25), np.float32(20.125)  # 40 duplicates
        for i, e in enumerate((10.5, 9.5)):
            e32 = np.float32(e)
            x[200 + 3 * i: 203 + 3 * i] = [e32, np.nextafter(e32, np.float32(np.inf)),
                                           np.nextafter(e32, np.float32(-np.inf))]
            y[200 + 3 * i: 203 + 3 * i] = np.float32(20.0)
    q = (10.0, 20.0, 0.5, knn_ops.lon_factor(20.0))
    return x, y, q


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("k", [1, 10, 120, 8192])
def test_knn_ops_on_the_card_match_the_cpu(dev, n, k):
    from geomesa_tpu_torch.ops import knn as knn_ops

    x, y, q = knn_case(n, seed=n + k)
    mask = np.random.default_rng(k).random(n) < 0.8
    out = []  # the card's answer, then the CPU's
    for d in (dev, torch.device("cpu")):
        xt, yt = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
        qt = knn_ops.query_vector(*q, d)
        out.append((knn_ops.knn_d2(xt, yt, qt).cpu(),
                    *(t.cpu() for t in knn_ops.knn(xt, yt, qt, k, torch.from_numpy(mask).to(d)))))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        assert torch.equal(a, b)
    idx, d2 = out[0][1:]
    if len(idx) > 1:  # nearest first, ties in row order
        assert bool(((d2[1:] > d2[:-1]) | ((d2[1:] == d2[:-1]) & (idx[1:] > idx[:-1]))).all())


def union_case(n, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n).astype(np.float32)
    y = rng.uniform(-10, 10, n).astype(np.float32)
    t = T0 + rng.integers(0, 86_400_000, n)
    c = rng.uniform(-10, 10, (m, 2))
    h = rng.uniform(0.01, 2.0, (m, 2))
    envs = np.concatenate([c - h, c + h], axis=1).astype(np.float32).astype(np.float64)
    envs[3::7] = envs[3::7][:, [2, 3, 0, 1]]  # inverted windows
    if n >= 16:  # rows on a window's edges and one and two ulps around them
        e = np.float32(envs[0, 2])
        up = np.nextafter(e, np.float32(np.inf))
        x[:4] = [e, up, np.nextafter(up, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf))]
        y[:4] = np.float32((envs[0, 1] + envs[0, 3]) / 2)
    t0 = T0 + rng.integers(0, 86_400_000, m)
    times = np.stack([t0, t0 + rng.integers(0, 86_400_000 // 4, m)], axis=1)
    return x, y, t, envs, times


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 17])
@pytest.mark.parametrize("m", [1, 2, 64, 257])
@pytest.mark.parametrize("with_times", [False, True], ids=["bbox", "bbox+time"])
def test_union_mask_on_the_card_matches_the_cpu(dev, n, m, with_times):
    from geomesa_tpu_torch.ops.int64lanes import split_array_np
    from geomesa_tpu_torch.ops.window import union_mask, widen

    x, y, t, envs, times = union_case(n, m, seed=n + m)
    hi, lo = split_array_np(t)
    out = []  # the card's answer, then the CPU's
    for d in (dev, torch.device("cpu")):
        lanes = ((torch.from_numpy(hi).to(d), torch.from_numpy(lo).to(d))
                 if with_times else (None, None))
        out.append(union_mask(torch.from_numpy(x).to(d), torch.from_numpy(y).to(d),
                              widen(envs), *lanes, times=times if with_times else None).cpu())
    torch.cuda.synchronize()
    assert torch.equal(*out)


def test_device_index_knn_and_windows_on_the_card(dev):
    """DeviceIndex.knn / window_union_query on the card equal the CPU
    index's answers, with labels, a base filter (one filter_scan_mask
    launch per call) and auths."""
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN
    from geomesa_tpu_torch.store.direct import BatchStore

    sft = SimpleFeatureType.create("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
    n = 200_000
    x, y, _ = knn_case(n, seed=5)
    rng = np.random.default_rng(6)
    cols = {"count": rng.integers(0, 100, n), "dtg": rng.integers(T0, T0 + 86_400_000, n),
            "geom": np.stack([x, y], axis=1).astype(np.float64),
            VIS_COLUMN: np.array(["", "A", "B"], object)[rng.integers(0, 3, n)]}
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    gpu = DeviceIndex(store, "t", device=dev)
    cpu = DeviceIndex(store, "t", device="cpu")
    _, _, _, envs, times = union_case(0, 33, seed=7)
    envs = envs / 10.0 + np.array([10.0, 20.0, 10.0, 20.0])
    for auths in (None, ("A",), ("A", "B")):
        for base in (None, "count > 50"):
            kernels.reset_counts()
            g = gpu.knn(10.0, 20.0, 500, query=base, auths=auths, max_radius_deg=0.5)
            c = cpu.knn(10.0, 20.0, 500, query=base, auths=auths, max_radius_deg=0.5)
            np.testing.assert_array_equal(g[0].fids, c[0].fids)
            np.testing.assert_array_equal(g[1], c[1])
            gu = gpu.window_union_query(envs, times, auths=auths, base=base)
            np.testing.assert_array_equal(gu.fids, cpu.window_union_query(envs, times, auths=auths,
                                                                          base=base).fids)
            assert kernels.LAUNCHES["filter_scan_mask"] == (2 if base else 0)


VALID_KINDS = ("dimscan_z3", "dimscan_z2", "zscan_z3", "zscan_z2", "filter_scan",
               "dimscan_batched_z3", "dimscan_batched_z2", "zscan_batched_z3", "zscan_batched_z2")


@pytest.mark.parametrize("n", [1, 5, 1000, (1 << 20) + 3])
@pytest.mark.parametrize("kind", VALID_KINDS)
def test_validity_operand_matches_plain(dev, n, kind):
    """Each kernel's count and mask with a validity plane (a null pointer,
    a plane of ones, 50% live, the last 2^20 rows dead, none live) equal
    its plain version ANDed with the plane, the batched ones at Q in {1,
    4, 64}: ``chip_smoke.check_validity``, phase 2's check at 2^26 rows."""
    errs = _CASES.Errs()
    before = kernels.VALID_LAUNCHES[f"{kind}_count"]
    assert _CASES.check_validity(dev, errs, n, seed=n, kinds=(kind,)) > 0
    assert kernels.VALID_LAUNCHES[f"{kind}_count"] > before
    assert all(v == 0 for v in errs.err.values())


def test_misaligned_validity_raises(dev):
    planes = [torch.zeros(64, dtype=torch.uint32, device=dev) for _ in range(2)]
    q = np.array([0, 1, 0, 1], np.uint32)
    valid = torch.ones(65, dtype=torch.bool, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        zscan.dimscan_count(q, *planes, valid=valid)
    with pytest.raises(ValueError, match="rows"):
        zscan.dimscan_count(q, *planes, valid=torch.ones(63, dtype=torch.bool, device=dev))


# -- the store path: one staged run, one mask launch ---------------------------

STORE_FILTERS = [
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-25T00:00:00Z",
    "count > 50",  # a full-table scan: every partition in one run
    "INTERSECTS(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0)))",  # envelope prefilter + residual
    "BBOX(geom, -60, -60, 60, 60) AND count IN (1, 2, 3, 42)",
]


@pytest.fixture(scope="module")
def stores(dev):
    """The same 2^20 + 17 rows in a MemoryDataStore scanning on the card
    and one scanning on the CPU (partitions of 2^18: a run of up to 8
    partitions stages up to 2^20 + 17 rows)."""
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    n = (1 << 20) + 17
    rng = np.random.default_rng(5)
    cols = {
        "count": rng.integers(0, 100, n),
        "dtg": rng.integers(T0, T0 + 60 * 86400_000, n),
        "geom": rng.uniform(-60, 60, (n, 2)).astype(np.float32).astype(np.float64),
    }
    out = []
    for device in (dev, "cpu"):
        ds = MemoryDataStore(partition_size=1 << 18, device=device)
        ds.create_schema("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
        ds.write("t", cols)
        ds.stats("t")  # flushes: the three index builds
        out.append(ds)
    return out


@pytest.mark.parametrize("ecql", STORE_FILTERS, ids=lambda s: s[:40])
def test_store_run_mask_matches_plain(stores, ecql):
    from geomesa_tpu_torch.query import runner

    card, cpu = stores
    plan = card.plan("t", ecql)
    built = card._state("t").indices[plan.index_name]
    runs = runner._contiguous_runs(built.prune(plan.ranges))
    kernels.reset_counts()
    got = card.query("t", ecql)
    assert kernels.LAUNCHES["filter_scan_mask"] == len(runs) >= 1
    assert not any(kernels.DEVICE_FN_CALLS.values())
    assert sum(v for k, v in kernels.LAUNCHES.items() if k != "filter_scan_mask") == 0
    want = cpu.query("t", ecql)
    np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
    assert got.scanned == want.scanned
    if ecql == "count > 50":
        assert runs == [(0, (1 << 20) + 17)]


# -- the file-system store: one mask launch per surviving partition ------------


@pytest.mark.parametrize("scheme", [None, "daily:z2-2bit"], ids=["no-scheme", "daily-z2"])
def test_fs_store_query_launches_once_per_partition(dev, tmp_path, scheme):
    """The same 2^20 + 17 rows in a FileSystemDataStore scanning on the card
    and one on the CPU: a bbox+during query launches ``filter_scan_mask``
    once per surviving partition and answers as the CPU does; the count
    pushdown's boundary chunks launch it too."""
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    n = (1 << 20) + 17
    rng = np.random.default_rng(6)
    cols = {
        "count": rng.integers(0, 100, n),
        "dtg": rng.integers(T0, T0 + 20 * 86400_000, n),
        "geom": rng.uniform(-60, 60, (n, 2)).astype(np.float32).astype(np.float64),
    }
    spec = "count:Int,dtg:Date,*geom:Point:srid=4326"
    if scheme:
        spec += f";geomesa.fs.partition-scheme={scheme}"
    card = FileSystemDataStore(str(tmp_path / "fs"), partition_size=1 << 18, device=dev)
    card.create_schema("t", spec)
    card.write("t", cols)
    card.flush("t")
    cpu = FileSystemDataStore(str(tmp_path / "fs"), partition_size=1 << 18, device="cpu")
    ecql = STORE_FILTERS[0]
    parts = card._pruned_parts("t", card.plan("t", ecql))
    kernels.reset_counts()
    got = card.query("t", ecql)
    assert kernels.LAUNCHES["filter_scan_mask"] == len(parts) >= 1
    assert not any(kernels.DEVICE_FN_CALLS.values())
    assert sum(v for k, v in kernels.LAUNCHES.items() if k != "filter_scan_mask") == 0
    want = cpu.query("t", ecql)
    np.testing.assert_array_equal(got.batch.fids, want.batch.fids)
    assert got.scanned == want.scanned
    kernels.reset_counts()
    assert card.count("t", ecql) == len(want)
    assert kernels.LAUNCHES["filter_scan_mask"] >= 1
