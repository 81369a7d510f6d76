"""CUDA kernels of ``geomesa_tpu_torch`` against their plain PyTorch
versions, on the card. Bit-exact: counts and masks are integers and the
float32 arithmetic is rounded op by op on both sides.

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
from geomesa_tpu_torch.ops import filter_scan, zscan
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
