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

pytestmark = pytest.mark.cuda

MAXI = (1 << 21) - 1
SENT = 0xFFFFFFFF
T0 = 1_577_836_800_000


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


def test_misaligned_planes_raise(dev):
    t = torch.zeros(65, dtype=torch.uint32, device=dev)
    q = np.array([0, 1, 0, 1], np.uint32)
    with pytest.raises(ValueError, match="aligned"):
        zscan.dimscan_count(q, t[1:], t[1:])


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
        # the global engine on the counted grids that take shared memory
        got_g = density._launch(x, y, DENSITY_ENV, width, height, mask, None, shared=False)
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
