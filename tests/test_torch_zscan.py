"""Port parity: ``geomesa_tpu_torch.ops.zscan`` against ``geomesa_tpu.ops.zscan``.

The port's dim-scan (plain PyTorch version, CPU tensors) is held against
the JAX package's Pallas runtime-bounds kernels in interpret mode, and the
plane packing and query-vector builders against the JAX package's.
Tolerance: bit-exact (counts, masks, planes and query vectors are
integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.curves.z2 import Z2SFC as JZ2SFC
from geomesa_tpu.curves.z3 import Z3SFC as JZ3SFC
from geomesa_tpu.ops import zscan as jz
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.ops import zscan as tz

torch.set_num_threads(2)  # xdist workers share the host's cores

MAXI = (1 << 21) - 1
SENT = 0xFFFFFFFF
T0 = 1_577_836_800_000  # 2020-01-01


def _planes(rng, n, with_bt=True):
    """u32 planes with edge rows: 0, max_index, the bt sentinel."""
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    bt = (
        (rng.integers(0, 6, n).astype(np.uint32) << np.uint32(21))
        | rng.integers(0, MAXI + 1, n).astype(np.uint32)
    )
    if n >= 8:
        nx[:4] = [0, MAXI, 0, MAXI]
        ny[:4] = [MAXI, 0, 0, MAXI]
        bt[:3] = [SENT, 0, (5 << 21) | MAXI]
    return nx, ny, (bt if with_bt else None)


def _qarr(rng, r):
    """Runtime query vector with R ranges; some inverted (never match),
    one reaching max_index."""
    q = np.empty(4 + 2 * r, np.uint32)
    lo = np.sort(rng.integers(0, MAXI + 1, 2))
    q[0:4] = [lo[0], MAXI, 0, rng.integers(0, MAXI + 1)]
    for k in range(r):
        a, b = np.sort(rng.integers(0, 6 << 21, 2))
        if k % 3 == 2:
            a, b = SENT, 0  # inverted pad range
        q[4 + 2 * k], q[5 + 2 * k] = a, b
    return q


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [1, 1000, 5003])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_z3_dimscan_matches_pallas_interpret(n, r):
    rng = np.random.default_rng(100 * r + n)
    nx, ny, bt = _planes(rng, n)
    q = _qarr(rng, r)
    count_fn, mask_fn = jz.build_z3_dimscan_rt(r, block_rows=8, interpret=True)
    jargs = (jnp.asarray(q), jnp.asarray(nx), jnp.asarray(ny), jnp.asarray(bt))
    want_m = np.asarray(mask_fn(*jargs))
    want_c = int(count_fn(*jargs))
    got_m = tz.dimscan_mask(q, _t(nx), _t(ny), _t(bt)).numpy()
    got_c = tz.dimscan_count(q, _t(nx), _t(ny), _t(bt))
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_m, want_m)
    assert int(got_c) == want_c == int(want_m.sum())


@pytest.mark.parametrize("n", [1, 1000, 5003])
def test_z2_dimscan_matches_pallas_interpret(n):
    rng = np.random.default_rng(7 + n)
    nx, ny, _ = _planes(rng, n, with_bt=False)
    q = _qarr(rng, 0)
    count_fn, mask_fn = jz.build_z2_dimscan_rt(block_rows=8, interpret=True)
    jargs = (jnp.asarray(q), jnp.asarray(nx), jnp.asarray(ny))
    want_m = np.asarray(mask_fn(*jargs))
    got_m = tz.dimscan_mask(q, _t(nx), _t(ny)).numpy()
    np.testing.assert_array_equal(got_m, want_m)
    assert int(tz.dimscan_count(q, _t(nx), _t(ny))) == int(count_fn(*jargs))


def test_dimscan_wrapper_rejects_bad_operands():
    nx = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError):  # a z3 query vector on 2 planes
        tz.dimscan_count(np.zeros(6, np.uint32), nx, nx)
    with pytest.raises(ValueError):  # R = 3 is not a bucket
        tz.dimscan_count(np.zeros(10, np.uint32), nx, nx, nx)
    with pytest.raises(TypeError):
        tz.dimscan_count(np.zeros(4, np.uint32), nx.to(torch.int32), nx)


def test_z3_dim_planes_match_jax():
    rng = np.random.default_rng(5)
    n = 4099
    nx = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    ny = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    nt = rng.integers(0, MAXI + 1, n).astype(np.uint32)
    # bins around the base, including below it (wraps to the sentinel)
    # and at/after the top packable bin
    bins = rng.integers(2600 - 3, 2600 + 2050, n).astype(np.int64)
    bins[:3] = [2600 - 1, 2600 + 2046, 2600 + 2047]
    want = jz.z3_dim_planes(JZ3SFC(), nx, ny, nt, bins.astype(np.uint32), 2600)
    got = tz.z3_dim_planes(
        Z3SFC(), _t(nx.astype(np.int64)), _t(ny.astype(np.int64)),
        _t(nt.astype(np.int64)), _t(bins), 2600,
    )
    for w, g in zip(want, got):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.uint32))


QUERIES = [
    ((-10.0, 35.0, 30.0, 60.0), (T0 + 9 * 86400_000, T0 + 14 * 86400_000)),
    ((-180.0, -90.0, 180.0, 90.0), (T0, T0 + 59 * 86400_000)),
    ((2.25, 48.75, 2.5, 49.0), (T0 + 3600_000, T0 + 7200_000)),
    ((179.5, 89.5, 180.0, 90.0), (T0 - 86400_000 * 30, T0 + 86400_000)),
    ((10.0, 10.0, 5.0, 5.0), (T0 + 86400_000, T0)),  # inverted both ways
]


@pytest.mark.parametrize("env,window", QUERIES)
@pytest.mark.parametrize("bin_range", [None, (2608, 2615)])
def test_z3_dim_plane_qarr_matches_jax(env, window, bin_range):
    want = jz.z3_dim_plane_qarr(JZ3SFC(), env, window, 2608, bin_range)
    got = tz.z3_dim_plane_qarr(Z3SFC(), env, window, 2608, bin_range)
    if want is None:
        assert got is None
        return
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.uint32


def test_z3_dim_plane_qarr_refusals_match_jax():
    # bins before the base are unpackable; >8 merged ranges are refused
    env = (0.0, 0.0, 1.0, 1.0)
    w = (T0, T0 + 86400_000)
    assert jz.z3_dim_plane_qarr(JZ3SFC(), env, w, 5000, None) is None
    assert tz.z3_dim_plane_qarr(Z3SFC(), env, w, 5000, None) is None
    for mr in (0, 1):
        a = jz.z3_dim_plane_qarr(JZ3SFC(), env, w, 2608, None, max_ranges=mr)
        b = tz.z3_dim_plane_qarr(Z3SFC(), env, w, 2608, None, max_ranges=mr)
        assert (a is None) == (b is None)


@pytest.mark.parametrize("env", [q[0] for q in QUERIES])
def test_z2_dim_plane_qarr_matches_jax(env):
    np.testing.assert_array_equal(
        tz.z2_dim_plane_qarr(Z2SFC(), env), jz.z2_dim_plane_qarr(JZ2SFC(), env)
    )


def test_normalize_t_matches_jax_quantization():
    from geomesa_tpu.curves.normalize import NormalizedDimension as JND

    from geomesa_tpu_torch.curves.normalize import NormalizedDimension

    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.uniform(-200.0, 200.0, 5000),
        [-180.0, 180.0, 179.99999999999997, -180.0000001, 0.0, 1e-300],
    ])
    for prec in (21, 31):
        ref = np.asarray(JND(-180.0, 180.0, prec).normalize_jax(jnp.asarray(v)))
        got = NormalizedDimension(-180.0, 180.0, prec).normalize_t(_t(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def _valid_planes(rng, n):
    """The validity patterns: every row live, 50% at random, the tail dead,
    none live."""
    tail = np.ones(n, bool)
    tail[n // 2:] = False
    return [np.ones(n, bool), rng.random(n) < 0.5, tail, np.zeros(n, bool)]


@pytest.mark.parametrize("n", [1, 1000, 5003])
@pytest.mark.parametrize("r", [0, 1, 2, 4, 8])
def test_dimscan_validity_is_the_plain_mask_anded(n, r):
    """The dim scan's plain version, count and mask with a validity plane
    equal the plain version without one ANDed with the plane (and the
    count its sum); the batched plain version with the plane equals Q
    single-query ones."""
    rng = np.random.default_rng(31 * r + n)
    nx, ny, bt = _planes(rng, n, with_bt=r > 0)
    planes = [_t(nx), _t(ny)] + ([_t(bt)] if r else [])
    q = _qarr(rng, r)
    qmat = np.stack([_qarr(rng, r) for _ in range(5)])
    base = tz.dimscan_plain(q, *planes)
    for v in map(_t, _valid_planes(rng, n)):
        want = base & v
        assert torch.equal(tz.dimscan_plain(q, *planes, valid=v), want)
        assert torch.equal(tz.dimscan_mask(q, *planes, valid=v), want)
        assert int(tz.dimscan_count(q, *planes, valid=v)) == int(want.sum())
        got = tz.batched_dimscan_mask(qmat, *planes, valid=v)
        singles = torch.stack([tz.dimscan_plain(row, *planes, valid=v) for row in qmat])
        assert torch.equal(got, singles)
        assert torch.equal(got, tz.batched_dim_mask_rt(r)(*planes, qmat) & v)
        assert tz.batched_dimscan_count(qmat, *planes, valid=v).tolist() == \
            singles.sum(dim=1).tolist()
    with pytest.raises(ValueError, match="rows"):
        tz.dimscan_count(q, *planes, valid=torch.ones(n + 1, dtype=torch.bool))
