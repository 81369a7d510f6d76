"""Port parity for the interleaved key layout: ``geomesa_tpu_torch``'s
Morton encodes, interleaved masked-compare scan, baked dim scan and
``DeviceIndex(dim_planes=False)`` against ``geomesa_tpu``'s, on the same
inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
``build_z3_pallas_scan`` and ``build_z3_dimscan_pallas`` in interpret
mode, the XLA masks, and its ``DeviceIndex`` with ``dim_planes=False`` or
its automatic fallback for day bins over more than 2,047 days. The port
runs its plain versions (CPU tensors). Inputs come from
``np.random.default_rng`` with float32-exact coordinates. Tolerance:
bit-exact for keys, planes, bounds, counts, masks, fid sets, integer grids
and stats; weighted grids within rtol 2e-5 / atol 1e-3, the counterpart's
own bound (its scatter sums in float32, the port's in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.curves import zorder as jzorder
from geomesa_tpu.curves.binnedtime import TimePeriod as JPeriod
from geomesa_tpu.curves.z2 import Z2SFC as JZ2SFC
from geomesa_tpu.curves.z3 import Z3SFC as JZ3SFC
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.ops import zscan as jz
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.convert import planes_from_numpy
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.binnedtime import TimePeriod
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.device_cache import Z_BIN, Z_HI, Z_LO, Z_NX, DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.ops import zscan as tz
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
WEEK_S = 604_800
T0 = 1_577_836_800_000  # 2020-01-01
T_WIDE0 = 1_424_217_600_000  # 2015-02-18
T_WIDE1 = 1_735_689_599_999  # 2024-12-31T23:59:59.999
Z3_SPEC = "count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,val:Double,*geom:Point:srid=4326"
WIDE_SPEC = Z3_SPEC + ";geomesa.z3.interval=day"
WEIGHTED = dict(rtol=2e-5, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- curves: the Morton encodes ------------------------------------------------


def _coords(n, seed, t_max):
    """Random lon/lat/offset with the edge rows: lon 180, lat 90, -180/-90,
    offsets 0 and at the period boundary (and one just below it)."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    t = rng.uniform(0, t_max, n)
    k = min(n, 5)
    x[:k] = [180.0, -180.0, 179.99999999, 0.0, 180.0][:k]
    y[:k] = [90.0, -90.0, 89.99999999, 0.0, -90.0][:k]
    t[:k] = [t_max, 0.0, np.nextafter(t_max, 0.0), t_max / 2, t_max][:k]
    return x, y, t


@pytest.mark.parametrize("period,t_max", [("week", WEEK_S), ("day", DAY)])
@pytest.mark.parametrize("n", [5, 4099, 1 << 17])
def test_z3_index_matches_jax(period, t_max, n):
    x, y, t = _coords(n, n, t_max)
    want = JZ3SFC(JPeriod.parse(period)).index(x, y, t)
    sfc = Z3SFC(TimePeriod.parse(period))
    got = sfc.index(x, y, t)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    hi, lo = sfc.index_hi_lo(_t(x), _t(y), _t(t))
    assert hi.dtype == lo.dtype == torch.uint32
    whi, wlo = jzorder.u64_hi_lo(want)
    np.testing.assert_array_equal(hi.numpy(), whi)
    np.testing.assert_array_equal(lo.numpy(), wlo)


@pytest.mark.parametrize("n", [5, 4099, 1 << 17])
def test_z2_index_matches_jax(n):
    x, y, _ = _coords(n, n + 1, 1.0)
    want = JZ2SFC().index(x, y)
    np.testing.assert_array_equal(Z2SFC().index(x, y), want)
    hi, lo = Z2SFC().index_hi_lo(_t(x), _t(y))
    whi, wlo = jzorder.u64_hi_lo(want)
    np.testing.assert_array_equal(hi.numpy(), whi)
    np.testing.assert_array_equal(lo.numpy(), wlo)


@pytest.mark.parametrize("dims", [2, 3])
def test_zorder_numpy_forms_match_jax(dims):
    rng = np.random.default_rng(dims)
    mx = zorder.MAX_MASK_2D if dims == 2 else zorder.MAX_MASK_3D
    v = rng.integers(0, mx + 1, (dims, 5000)).astype(np.uint64)
    v[:, 0], v[:, 1] = 0, mx  # the corners
    if dims == 2:
        z = zorder.encode_2d_np(*v)
        np.testing.assert_array_equal(z, jzorder.encode_2d_np(*v))
        np.testing.assert_array_equal(zorder.split_2d_np(v[0]), jzorder.split_2d_np(v[0]))
        np.testing.assert_array_equal(np.stack(zorder.decode_2d_np(z)), v)
        np.testing.assert_array_equal(zorder.combine_2d_np(z), jzorder.combine_2d_np(z))
    else:
        z = zorder.encode_3d_np(*v)
        np.testing.assert_array_equal(z, jzorder.encode_3d_np(*v))
        np.testing.assert_array_equal(zorder.split_3d_np(v[0]), jzorder.split_3d_np(v[0]))
        np.testing.assert_array_equal(np.stack(zorder.decode_3d_np(z)), v)
        np.testing.assert_array_equal(zorder.combine_3d_np(z), jzorder.combine_3d_np(z))
    enc = zorder.encode_2d_t if dims == 2 else zorder.encode_3d_hi_lo_t
    jenc = jzorder.encode_2d_jax if dims == 2 else jzorder.encode_3d_hi_lo_jax
    got = enc(*[_t(a.astype(np.int32)) for a in v])
    want = jenc(*[jnp.asarray(a.astype(np.int32)) for a in v])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- query builders -------------------------------------------------------------

ENVS = [
    (-10.0, 35.0, 30.0, 60.0),
    (-180.0, -90.0, 180.0, 90.0),
    (179.5, 89.5, 180.0, 90.0),
    (10.0, 10.0, 5.0, 5.0),  # inverted
]
WINDOWS = [
    (T0 + 9 * DAY, T0 + 14 * DAY),
    (T0, T0 + 59 * DAY),
    (T0 + 3600_000, T0 + 7200_000),
    (T0 + DAY, T0),  # inverted
]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("period", ["week", "day"])
def test_z3_query_bounds_match_jax(env, window, period):
    want_b, want_i = jz.z3_query_bounds(JZ3SFC(JPeriod.parse(period)), *env, *window)
    got_b, got_i = tz.z3_query_bounds(Z3SFC(TimePeriod.parse(period)), *env, *window)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_b.dtype == np.uint32 and got_i.dtype == np.int32
    for min_b in (1, 4):
        for g, w in zip(tz.pad_bins(got_b, got_i, min_b), jz.pad_bins(want_b, want_i, min_b)):
            np.testing.assert_array_equal(g, w)
    dq = tz.z3_dim_plane_query(Z3SFC(TimePeriod.parse(period)), *env, *window, 2600)
    jdq = jz.z3_dim_plane_query(JZ3SFC(JPeriod.parse(period)), *env, *window, 2600)
    assert dq == jdq


@pytest.mark.parametrize("env", ENVS)
def test_z2_dim_bounds_match_jax(env):
    sfc = Z2SFC()
    qlo = (int(sfc.lon.normalize(env[0])), int(sfc.lat.normalize(env[1])))
    qhi = (int(sfc.lon.normalize(env[2])), int(sfc.lat.normalize(env[3])))
    np.testing.assert_array_equal(tz.z2_dim_bounds(qlo, qhi), jz.z2_dim_bounds(qlo, qhi))


@pytest.mark.parametrize("kind", ["xz3", "xz2"])
def test_kind_mask_fn_xz_kinds_match_jax(kind):
    """The xz kinds dispatch to the port's range masks, which answer as
    the JAX package's on the same codes and bounds."""
    from geomesa_tpu.curves.xz2 import XZ2SFC as JXZ2
    from geomesa_tpu.curves.xz3 import XZ3SFC as JXZ3

    assert tz.kind_mask_fn("z3") is tz.z3_zscan_mask
    assert tz.kind_mask_fn("z2") is tz.z2_zscan_mask
    rng = np.random.default_rng(11)
    n = 2000
    x0, y0 = rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)
    x1, y1 = x0 + rng.uniform(0, 2, n), y0 + rng.uniform(0, 2, n)
    off = rng.uniform(0, 604800, n)
    bins = rng.integers(2606, 2611, n).astype(np.int32)
    if kind == "xz2":
        code = JXZ2().index(x0, y0, x1, y1)
        bounds = jz.pad_ranges(jz.xz2_query_bounds(JXZ2(), -10, -5, 12, 8))
        args, jargs = (bounds,), (jnp.asarray(bounds),)
    else:
        code = JXZ3().index(x0, y0, off, x1, y1, off)
        bounds, ids = jz.pad_bins(*jz.xz3_query_bounds(
            JXZ3(), -10, -5, 12, 8, 2607 * 604_800_000 + 5 * 86_400_000,
            2609 * 604_800_000 + 2 * 86_400_000))
        args = (torch.from_numpy(bins), bounds, ids)
        jargs = (jnp.asarray(bins), jnp.asarray(bounds), jnp.asarray(ids))
    c = code.astype(np.uint64)
    hi = (c >> np.uint64(32)).astype(np.uint32)
    lo = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    got = tz.kind_mask_fn(kind)(torch.from_numpy(hi), torch.from_numpy(lo), *args)
    want = np.asarray(jz.kind_mask_fn(kind)(jnp.asarray(hi), jnp.asarray(lo), *jargs))
    assert 0 < want.sum() < n
    np.testing.assert_array_equal(got.numpy(), want)


# -- the interleaved scan and the baked dim scan --------------------------------


def _keys(n, seed, n_bins=20, base=2606):
    """Interleaved Z3 keys of float32-exact points over ``n_bins`` week bins."""
    rng = np.random.default_rng(seed)
    x, y, off = _coords(n, seed, WEEK_S)
    bins = (base + rng.integers(0, n_bins, n)).astype(np.int32)
    hi, lo = jzorder.u64_hi_lo(JZ3SFC().index(x, y, off))
    return rng, bins, hi, lo


SCAN_CASES = [  # (n, env, first day, days): 1 bin to 20 bins (padded to 32)
    (1, ENVS[0], 9, 5),
    (1000, ENVS[0], 9, 5),
    (30011, ENVS[1], 0, 1),
    (30011, (-60.0, -30.0, 60.0, 30.0), 3, 40),
    (30011, ENVS[2], 0, 139),
    (30011, ENVS[3], 9, 5),
]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: f"n{c[0]}-{c[3]}d")
def test_z3_zscan_matches_jax(case):
    n, env, d0, days = case
    _, bins, hi, lo = _keys(n, n + days)
    w = (T0 + d0 * DAY + 3600_000, T0 + (d0 + days) * DAY)
    bounds, ids = jz.pad_bins(*jz.z3_query_bounds(JZ3SFC(), *env, *w))
    want = np.asarray(jz.z3_zscan_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bins),
                                       jnp.asarray(bounds), jnp.asarray(ids)))
    count_fn, mask_fn = jz.build_z3_pallas_scan(bounds, ids)
    pallas = np.asarray(mask_fn(jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(pallas, want)
    tcount, tmask = tz.build_z3_pallas_scan(bounds, ids)
    got = tmask(_t(bins), _t(hi), _t(lo))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tz.z3_zscan_mask(_t(hi), _t(lo), _t(bins), bounds, ids).numpy(), want)
    c = tcount(_t(bins), _t(hi), _t(lo))
    assert c.dtype == torch.int32 and int(c) == int(count_fn(
        jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo))) == int(want.sum())


@pytest.mark.parametrize("b", [1, 3, 17])
def test_z3_zscan_random_bounds_match_pallas_interpret(b):
    """Arbitrary bound words and ids (some padded) through the counterpart's
    Pallas kernel: the masked compares as unsigned 64-bit words."""
    rng, bins, hi, lo = _keys(20011, b, n_bins=24)
    bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
    bounds[:, :, 0:2] = rng.integers(0, 1 << 32, (b, 3, 2), dtype=np.uint64) & 0x0F0F0F0F
    ids = (2606 + rng.permutation(24)[:b]).astype(np.int32)
    ids[::3] = -1
    _, mask_fn = jz.build_z3_pallas_scan(bounds, ids)
    want = np.asarray(mask_fn(jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(tz.build_z3_pallas_scan(bounds, ids)[1](
        _t(bins), _t(hi), _t(lo)).numpy(), want)


# -- the kernel's bin-to-entry table -----------------------------------------


@pytest.mark.parametrize("ids,first,table", [
    ([2606, 2607, 2608], 2606, [0, 1, 2]),  # contiguous
    ([2610, 2606, 2608], 2606, [1, -1, 2, -1, 0]),  # gapped, out of order
    ([2606, 2607, -1, -1], 2606, [0, 1]),  # padded to a power of two
    ([-1, 2608, -1, 2606], 2606, [3, -1, 1]),  # padding among real entries
    ([-1, -1], 0, []),  # all padding: no table, nothing matches
    ([0], 0, [0]),  # the epoch's own bin
], ids=["contiguous", "gapped", "padded", "padding-among", "all-padding", "bin-0"])
def test_entry_table(ids, first, table):
    f, entry_of = tz.entry_table(np.array(ids, np.int32))
    assert f == first and entry_of.dtype == np.int32
    np.testing.assert_array_equal(entry_of, np.array(table, np.int32))


def test_entry_table_refuses_shared_bins_and_wide_spans():
    with pytest.raises(ValueError, match="share a bin"):
        tz.entry_table(np.array([2606, 2607, 2606], np.int32))
    with pytest.raises(ValueError, match="span"):
        tz.entry_table(np.array([0, tz.ZSCAN_MAX_SPAN], np.int32))
    tz.entry_table(np.array([0, tz.ZSCAN_MAX_SPAN - 1], np.int32))  # the widest span taken


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: f"n{c[0]}-{c[3]}d")
def test_z3_zscan_lookup_matches_jax(case):
    """The plain version on the kernel's table layout (one lookup per row)
    against the counterpart's XLA mask and its Pallas kernel in interpret
    mode, over 1 to 20 real bins padded to a power of two."""
    n, env, d0, days = case
    _, bins, hi, lo = _keys(n, n + days + 1)
    w = (T0 + d0 * DAY + 3600_000, T0 + (d0 + days) * DAY)
    bounds, ids = jz.pad_bins(*jz.z3_query_bounds(JZ3SFC(), *env, *w))
    want = np.asarray(jz.z3_zscan_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bins),
                                       jnp.asarray(bounds), jnp.asarray(ids)))
    pallas = np.asarray(jz.build_z3_pallas_scan(bounds, ids)[1](
        jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(pallas, want)
    first, entry_of = tz.entry_table(ids)
    got = tz.z3_zscan_lookup(_t(hi), _t(lo), _t(bins), bounds, first, entry_of)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [1, 2, 17, 24])
def test_z3_zscan_lookup_random_bounds_match_pallas_interpret(b):
    """Arbitrary bound words over gapped, shuffled and padded ids; rows in
    bins past both ends of the table and in bin -1."""
    rng, bins, hi, lo = _keys(20011, 40 + b, n_bins=26, base=2605)
    bins[:50] = -1
    bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
    bounds[:, :, 0:2] = rng.integers(0, 1 << 32, (b, 3, 2), dtype=np.uint64) & 0x0F0F0F0F
    ids = (2606 + rng.permutation(24)[:b]).astype(np.int32)
    ids[1::3] = -1
    want = np.asarray(jz.build_z3_pallas_scan(bounds, ids)[1](
        jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo)))
    first, entry_of = tz.entry_table(ids)
    got = tz.z3_zscan_lookup(_t(hi), _t(lo), _t(bins), bounds, first, entry_of).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tz.z3_zscan_mask(_t(hi), _t(lo), _t(bins), bounds, ids).numpy(), want)


def test_negative_ids_are_padding_as_in_the_pallas_kernel():
    """Entries with ids < 0 never match, as in the counterpart's Pallas
    kernel, also where rows lie in bin -1 (the week before the epoch; the
    counterpart's XLA mask lets such rows match a padded entry's all-zero
    bounds). An all-padded query counts 0."""
    rng, bins, hi, lo = _keys(5003, 9, n_bins=3, base=-1)
    assert (bins == -1).any()
    jb, jh, jl = jnp.asarray(bins), jnp.asarray(hi), jnp.asarray(lo)
    bounds, ids = np.zeros((4, 3, 6), np.uint32), np.full(4, -1, np.int32)
    assert int(jz.build_z3_pallas_scan(bounds, ids)[0](jb, jh, jl)) == 0
    tcount, tmask = tz.build_z3_pallas_scan(bounds, ids)
    assert int(tcount(_t(bins), _t(hi), _t(lo))) == 0 and not tmask(_t(bins), _t(hi), _t(lo)).any()
    assert np.asarray(jz.z3_zscan_mask(jh, jl, jb, jnp.asarray(bounds), jnp.asarray(ids)))[
        bins == -1].all()
    # a window over bins -1 and 0: the bin -1 entry reads as padding too
    bounds, ids = jz.pad_bins(*jz.z3_query_bounds(JZ3SFC(), -180, -90, 180, 90, -WEEK_S * 1000, 3 * DAY), 4)
    want = np.asarray(jz.build_z3_pallas_scan(bounds, ids)[1](jb, jh, jl))
    got = tz.build_z3_pallas_scan(bounds, ids)[1](_t(bins), _t(hi), _t(lo)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[bins == -1].any() and got[bins == 0].any()


def test_loose_window_over_a_bin_before_1970_takes_the_exact_scan():
    """So the port's interleaved index loses no row of a negative bin: a
    loose window that reaches one is answered by the exact scan."""
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    cols = _columns(4001, seed=8, t0=-20 * DAY, t1=20 * DAY)
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", Z3_SPEC), cols))
    tdi = DeviceIndex(store, "t", z_planes=True, dim_planes=False, device="cpu")
    before = f"BBOX(geom, -60, -40, 100, 55) AND {_during(-15, 5, 0)}"
    after = f"BBOX(geom, -60, -40, 100, 55) AND {_during(8, 18, 0)}"
    assert tdi._loose_bounds(parse_ecql(before)) is None
    assert tdi.count(before, loose=True) == tdi.count(before) > 0
    assert tdi._loose_bounds(parse_ecql(after))[0] == "zscan"
    assert tdi.count(after, loose=True) >= tdi.count(after) > 0


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("random_words", [False, True])
def test_z2_zscan_matches_jax(env, random_words):
    rng = np.random.default_rng(int(env[0]) + 500)
    x, y, _ = _coords(20011, 77, 1.0)
    hi, lo = jzorder.u64_hi_lo(JZ2SFC().index(x, y))
    sfc = Z2SFC()
    bounds = tz.z2_dim_bounds(
        (int(sfc.lon.normalize(env[0])), int(sfc.lat.normalize(env[1]))),
        (int(sfc.lon.normalize(env[2])), int(sfc.lat.normalize(env[3]))),
    )
    if random_words:
        bounds = rng.integers(0, 1 << 32, (2, 6), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jz.z2_zscan_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bounds)))
    count_fn, mask_fn = tz.build_z2_zscan(bounds)
    np.testing.assert_array_equal(mask_fn(_t(hi), _t(lo)).numpy(), want)
    assert int(count_fn(_t(hi), _t(lo))) == int(want.sum())


def _dim_planes(n, seed):
    rng = np.random.default_rng(seed)
    maxi = (1 << 21) - 1
    nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
    ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
    bt = ((rng.integers(0, 9, n).astype(np.uint32) << np.uint32(21))
          | rng.integers(0, maxi + 1, n).astype(np.uint32))
    bt[: min(n, 2)] = 0xFFFFFFFF
    return nx, ny, bt


BAKED_CASES = [  # (env, window): 0 to several bt ranges
    (ENVS[0], WINDOWS[0]),
    (ENVS[1], WINDOWS[1]),
    (ENVS[2], WINDOWS[2]),
    (ENVS[0], WINDOWS[3]),
]


@pytest.mark.parametrize("n", [1, 1000, 70_001])
@pytest.mark.parametrize("case", BAKED_CASES, ids=lambda c: f"{c[0][0]}-{c[1][1] - c[1][0]}")
def test_baked_dimscan_matches_pallas_interpret(n, case):
    nx, ny, bt = _dim_planes(n, n)
    qnx, qny, ranges = jz.z3_dim_plane_query(JZ3SFC(), *case[0], *case[1], 2608)
    count_fn, mask_fn = jz.build_z3_dimscan_pallas(qnx, qny, ranges)
    ja = (jnp.asarray(nx), jnp.asarray(ny), jnp.asarray(bt))
    want = np.asarray(jz.z3_dimscan_mask(*ja, qnx, qny, ranges))
    np.testing.assert_array_equal(np.asarray(mask_fn(*ja)), want)
    tcount, tmask = tz.build_z3_dimscan_pallas(qnx, qny, ranges)
    np.testing.assert_array_equal(tmask(_t(nx), _t(ny), _t(bt)).numpy(), want)
    assert int(tcount(_t(nx), _t(ny), _t(bt))) == int(count_fn(*ja)) == int(want.sum())


@pytest.mark.parametrize("r", [0, 2, 5, 16])
def test_baked_dimscan_many_ranges_match_jax(r):
    """Hand-built range lists, inverted ones included: the counterpart's
    XLA mask and the port's plain version."""
    nx, ny, bt = _dim_planes(5003, r)
    rng = np.random.default_rng(r)
    ranges = [tuple(int(v) for v in np.sort(rng.integers(0, 9 << 21, 2))) for _ in range(r)]
    if r > 1:
        ranges[1] = (0xFFFFFFFF, 0)
    qnx, qny = (1000, 2_000_000), (0, (1 << 21) - 1)
    want = np.asarray(jz.z3_dimscan_mask(jnp.asarray(nx), jnp.asarray(ny), jnp.asarray(bt),
                                         qnx, qny, ranges))
    np.testing.assert_array_equal(tz.z3_dimscan_mask(_t(nx), _t(ny), _t(bt), qnx, qny, ranges)
                                  .numpy(), want)
    with pytest.raises(ValueError, match="ranges"):
        tz.build_z3_dimscan_pallas(qnx, qny, [(0, 1)] * (tz.BAKED_MAX_RANGES + 1))


def test_interleaved_and_dim_planes_answer_alike():
    """The two key layouts hold the same cell-granular answer (the
    counterpart's own cross-check): the interleaved scan over the Morton
    key and the dim scans over the de-interleaved planes."""
    from geomesa_tpu_torch.curves.binnedtime import to_binned_time

    rng = np.random.default_rng(3)
    n = 30011
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ms = rng.integers(T0, T0 + 60 * DAY, n)
    sfc = Z3SFC()
    bins, off = to_binned_time(ms, sfc.period)
    hi, lo = sfc.index_hi_lo(_t(x), _t(y), _t(off.astype(np.float64)))
    base = int(bins.min())
    nx, ny, bt = tz.z3_dim_planes(sfc, sfc.lon.normalize_t(_t(x)), sfc.lat.normalize_t(_t(y)),
                                  sfc.time.normalize_t(_t(off.astype(np.float64))), _t(bins), base)
    hits = 0
    for env in ENVS[:3]:
        for w in WINDOWS[:3]:
            bounds, ids = tz.pad_bins(*tz.z3_query_bounds(sfc, *env, *w))
            inter = tz.build_z3_pallas_scan(bounds, ids)[1](_t(bins.astype(np.int32)), hi, lo)
            qarr, _ = tz.z3_dim_plane_qarr(sfc, env, w, base, None)
            qnx, qny, ranges = tz.z3_dim_plane_query(sfc, *env, *w, base)
            assert torch.equal(inter, tz.dimscan_mask(qarr, nx, ny, bt))
            assert torch.equal(inter, tz.build_z3_dimscan_pallas(qnx, qny, ranges)[1](nx, ny, bt))
            hits += int(inter.sum())
    assert hits > 0


# -- DeviceIndex(dim_planes=False) in both packages -----------------------------


def _columns(n, seed, with_dtg=True, t0=T0, t1=T0 + 60 * DAY, labels=False):
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-60, -40], [100, 55], (6, 2))
    xy = centres[rng.integers(0, 6, n)] + rng.normal(0, 3.0, (n, 2))
    uni = rng.uniform([-180, -90], [180, 90], (n, 2))
    xy = np.clip(np.where(rng.uniform(size=(n, 1)) < 0.85, xy, uni), [-180, -90], [180, 90])
    xy[:4] = [[-10.0, 35.0], [30.0, 60.0], [180.0, 90.0], [-180.0, -90.0]]
    cols = {
        "count": rng.integers(0, 1000, n),
        "val": rng.uniform(0.5, 2.0, n).astype(np.float32).astype(np.float64),
        "geom": xy.astype(np.float32).astype(np.float64),
    }
    if with_dtg:
        cols["dtg"] = rng.integers(t0, t1, n)
        cols["dtg"][:2] = [t0, t1]  # on the first and the last bin
    if labels:
        cols[VIS_COLUMN] = rng.choice(["", "A", "A&B", "B|C"], n)
    return cols


def _pair(spec, cols, dim_planes=False):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    jsft, sft = JSFT.create("t", spec), SimpleFeatureType.create("t", spec)
    jdi = JIndex(JStore(JBatch.from_columns(jsft, cols)), "t", z_planes=True,
                 dim_planes=dim_planes)
    batch = FeatureBatch.from_columns(sft, cols)
    tdi = DeviceIndex(BatchStore(batch), "t", z_planes=True, dim_planes=dim_planes,
                      device="cpu")
    return jdi, tdi, sft, batch


@pytest.fixture(scope="module")
def z3():
    return _pair(Z3_SPEC, _columns(20011, seed=1))


@pytest.fixture(scope="module")
def z2():
    return _pair(Z2_SPEC, _columns(20011, seed=2, with_dtg=False))


@pytest.fixture(scope="module")
def wide():
    """Day bins over 2015-02-18 .. 2024-12-31: about 3,600 bins, more than
    the bt word packs, so both packages fall back to the interleaved key."""
    return _pair(WIDE_SPEC, _columns(1 << 16, seed=3, t0=T_WIDE0, t1=T_WIDE1), dim_planes=None)


@pytest.fixture(scope="module")
def labeled():
    return _pair(Z3_SPEC, _columns(8009, seed=4, labels=True))


def _during(d0, d1, base=T0):
    iso = lambda ms: str(np.datetime64(int(ms), "ms")) + "Z"  # noqa: E731
    return f"dtg DURING {iso(base + d0 * DAY)}/{iso(base + d1 * DAY)}"


Z3_QUERIES = [
    f"BBOX(geom, -10, 35, 30, 60) AND {_during(9, 14)}",
    f"BBOX(geom, -180, -90, 180, 90) AND {_during(0, 1)}",
    f"BBOX(geom, 2.25, 48.5, 2.75, 49) AND {_during(4, 32)}",
    f"BBOX(geom, -130, 20, -60, 55) AND {_during(31.27, 33.75)}",
    f"BBOX(geom, 179.5, 89.5, 180, 90) AND {_during(-30, 90)}",
    f"BBOX(geom, -10, 35, 30, 60) AND {_during(400, 430)}",  # no staged bin
    f"BBOX(geom, 10, 10, 5, 5) AND {_during(9, 14)}",
    "BBOX(geom, -60, -30, 60, 30)",
    _during(27, 35.5),
    f"BBOX(geom, -10, 35, 30, 60) AND {_during(9, 14)} AND count > 500",
    "INCLUDE",
]
Z2_QUERIES = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -180, -90, 180, 90)",
    "BBOX(geom, 179.5, 89.5, 180, 90)",
    "BBOX(geom, 10, 10, 5, 5)",
    "BBOX(geom, -130, 20, -60, 55) AND count < 100",
]
WIDE_QUERIES = [  # 1 day to 8 weeks, then past 64 bins (the exact scan)
    f"BBOX(geom, -10, 35, 30, 60) AND {_during(100, 101, T_WIDE0)}",
    f"BBOX(geom, -60, -40, 100, 55) AND {_during(2000.5, 2007, T_WIDE0)}",
    f"BBOX(geom, -180, -90, 180, 90) AND {_during(3000, 3028, T_WIDE0)}",
    f"BBOX(geom, -60, -40, 100, 55) AND {_during(1500, 1556, T_WIDE0)}",
    f"BBOX(geom, -60, -40, 100, 55) AND {_during(700, 770, T_WIDE0)}",
    f"BBOX(geom, 0, 0, 60, 40) AND {_during(-10, 3, T_WIDE0)}",
]


def _assert_same(jdi, tdi, ecql):
    assert tdi.count(ecql, loose=True) == jdi.count(ecql, loose=True)
    assert tdi.count(ecql, loose=False) == jdi.count(ecql, loose=False)
    for loose in (False, True):
        np.testing.assert_array_equal(tdi.mask(ecql, loose=loose), jdi.mask(ecql, loose=loose))
        np.testing.assert_array_equal(
            np.sort(tdi.query(ecql, loose=loose).fids),
            np.sort(jdi.query(ecql, loose=loose).fids),
        )


@pytest.mark.parametrize("which", ["z3", "z2", "wide", "labeled"])
def test_staged_interleaved_planes_match(z3, z2, wide, labeled, which):
    jdi, tdi, _, _ = {"z3": z3, "z2": z2, "wide": wide, "labeled": labeled}[which]
    assert not jdi._dim_mode and not tdi._dim_mode and Z_NX not in tdi._cols
    names = [Z_HI, Z_LO] + ([Z_BIN] if tdi._z_kind == "z3" else [])
    for k in names:
        got, want = tdi._cols[k].numpy(), np.asarray(jdi._cols[k])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tdi._bin_range == jdi._bin_range


@pytest.mark.parametrize("ecql", Z3_QUERIES, ids=lambda s: s[:48])
def test_z3_interleaved_counts_masks_and_fids_match(z3, ecql):
    jdi, tdi, _, _ = z3
    _assert_same(jdi, tdi, ecql)


@pytest.mark.parametrize("ecql", Z2_QUERIES)
def test_z2_interleaved_counts_masks_and_fids_match(z2, ecql):
    jdi, tdi, _, _ = z2
    _assert_same(jdi, tdi, ecql)


@pytest.mark.parametrize("ecql", WIDE_QUERIES, ids=lambda s: s[-50:])
def test_wide_span_day_bins_match_the_fallback(wide, ecql):
    jdi, tdi, _, _ = wide
    _assert_same(jdi, tdi, ecql)
    assert tdi._bin_range[1] - tdi._bin_range[0] > 2047


def test_wide_span_routes_by_bin_count(wide):
    """Windows of up to 64 day bins take the interleaved scan; longer ones
    go to the exact scan, as in the counterpart."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    _, tdi, _, _ = wide
    routes = [tdi._loose_bounds(parse_ecql(q)) for q in WIDE_QUERIES]
    assert [r is not None and r[0] for r in routes] == ["zscan"] * 4 + [False, "zscan"]
    assert [len(r[2]) for r in routes if r] == [2, 8, 32, 64, 4]


DENSITY_CASES = [  # (filter, loose, envelope, (width, height), weight)
    (Z3_QUERIES[0], True, (-10.0, 35.0, 30.0, 60.0), (64, 32), None),
    (Z3_QUERIES[8], True, (-180.0, -90.0, 180.0, 90.0), (128, 64), None),
    (Z3_QUERIES[3], True, (-130.0, 20.0, -60.0, 55.0), (600, 3), "val"),
    (Z3_QUERIES[0], False, (-10.0, 35.0, 30.0, 60.0), (64, 32), "count"),
]


@pytest.mark.parametrize("case", DENSITY_CASES, ids=lambda c: f"{c[1]}-{c[3]}-{c[4]}")
def test_interleaved_density_matches(z3, case):
    jdi, tdi, _, _ = z3
    f, loose, env, (w, h), weight = case
    want = jdi.density(f, JEnvelope(*env), w, h, weight_attr=weight, loose=loose)
    got = tdi.density(f, Envelope(*env), w, h, weight_attr=weight, loose=loose)
    assert got.shape == want.shape and got.dtype == np.float32 and got.sum() > 0
    if weight is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **WEIGHTED)


STATS = 'Count();MinMax("count");MinMax("dtg");Histogram("val",16,0.5,2.0)'


@pytest.mark.parametrize("which,ecql", [
    ("z3", Z3_QUERIES[0]), ("z3", Z3_QUERIES[8]), ("wide", WIDE_QUERIES[2]),
    ("wide", WIDE_QUERIES[4]),
])
def test_interleaved_stats_match(z3, wide, which, ecql):
    jdi, tdi, _, _ = z3 if which == "z3" else wide
    for loose in (True, False):
        assert tdi.stats(ecql, STATS, loose=loose).to_json() == \
            jdi.stats(ecql, STATS, loose=loose).to_json()


@pytest.mark.parametrize("auths", [None, ("A",), ("A", "B", "C")])
def test_labeled_interleaved_index_matches(labeled, auths):
    jdi, tdi, _, _ = labeled
    for ecql in Z3_QUERIES[:3]:
        for loose in (True, False):
            assert tdi.count(ecql, loose=loose, auths=auths) == \
                jdi.count(ecql, loose=loose, auths=auths)
            np.testing.assert_array_equal(tdi.mask(ecql, loose=loose, auths=auths),
                                          jdi.mask(ecql, loose=loose, auths=auths))
    env = (-180.0, -90.0, 180.0, 90.0)
    np.testing.assert_array_equal(
        tdi.density(Z3_QUERIES[2], Envelope(*env), 64, 32, loose=True, auths=auths),
        jdi.density(Z3_QUERIES[2], JEnvelope(*env), 64, 32, loose=True, auths=auths),
    )


@pytest.mark.parametrize("which", ["z3", "z2", "wide"])
def test_index_from_jax_interleaved_planes_answers_identically(z3, z2, wide, which):
    jdi, _, sft, batch = {"z3": z3, "z2": z2, "wide": wide}[which]
    jcols = {k: np.asarray(v) for k, v in jdi._cols.items()}
    planes = planes_from_numpy(jcols, "cpu")
    for k in (Z_BIN, Z_HI, Z_LO):
        if k in jcols:
            assert planes[k].numpy().dtype == jcols[k].dtype
            np.testing.assert_array_equal(planes[k].numpy(), jcols[k])
    tdi = DeviceIndex.from_planes(sft, batch, planes, jdi._bt_base, jdi._bin_range, device="cpu")
    assert not tdi._dim_mode
    queries = {"z3": Z3_QUERIES, "z2": Z2_QUERIES, "wide": WIDE_QUERIES}[which]
    for ecql in queries[:4]:
        _assert_same(jdi, tdi, ecql)


def test_loose_scan_kernel_is_what_count_launches(z3, z2, labeled):
    for pair, ecql in ((z3, Z3_QUERIES[0]), (z2, Z2_QUERIES[0])):
        _, tdi, _, _ = pair
        count_fn, ops = tdi.loose_scan_kernel(ecql)
        assert int(count_fn(*ops)) == tdi.count(ecql, loose=True)
    assert z3[1].loose_scan_kernel("INCLUDE") is None
    assert labeled[1].loose_scan_kernel(Z3_QUERIES[0]) is None


def test_interleaved_path_goes_through_the_kernel_wrappers(z3, z2):
    """On CPU tensors the wrappers run the plain versions and count no
    launches; the loose path never takes the dim scan here."""
    kernels.reset_counts()
    z3[1].count(Z3_QUERIES[0], loose=True)
    z3[1].mask(Z3_QUERIES[0], loose=True)
    z2[1].count(Z2_QUERIES[0], loose=True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_dim_planes_preference_matches_the_reference():
    """dim_planes=True refuses what the bt word cannot pack, with the
    counterpart's message; the default falls back."""
    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    cols = _columns(512, seed=5, t0=T_WIDE0, t1=T_WIDE1)
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", WIDE_SPEC), cols))
    with pytest.raises(ValueError, match="cannot pack them"):
        DeviceIndex(store, "t", z_planes=True, dim_planes=True, device="cpu")
    assert not DeviceIndex(store, "t", z_planes=True, device="cpu")._dim_mode
    narrow = BatchStore(FeatureBatch.from_columns(
        SimpleFeatureType.create("t", Z3_SPEC), _columns(512, seed=6)))
    assert DeviceIndex(narrow, "t", z_planes=True, device="cpu")._dim_mode
    assert not DeviceIndex(narrow, "t", z_planes=True, dim_planes=False, device="cpu")._dim_mode


@pytest.mark.parametrize("case", SCAN_CASES[:4], ids=lambda c: f"n{c[0]}-{c[3]}d")
def test_zscan_validity_is_the_plain_mask_anded(case):
    """The interleaved scan's plain version (on the kernel's table
    layout), count and mask with a validity plane equal the plain version
    without one ANDed with the plane; also for the z2 variant."""
    n, env, d0, days = case
    rng, bins, hi, lo = _keys(n, n + days + 1)
    w = (T0 + d0 * DAY + 3600_000, T0 + (d0 + days) * DAY)
    bounds, ids = jz.pad_bins(*jz.z3_query_bounds(JZ3SFC(), *env, *w))
    scan = tz._ZScan(bounds, ids)
    count_fn, mask_fn = tz.build_z3_pallas_scan(bounds, ids)
    planes = (_t(bins), _t(hi), _t(lo))
    base = scan.plain(*planes)
    z2 = tz._ZScan(tz.z2_dim_bounds((0, 0), (1 << 30, 1 << 30)), None)
    c2, m2 = tz.build_z2_zscan(z2.bounds[0])
    base2 = z2.plain(None, _t(hi), _t(lo))
    tail = np.ones(n, bool)
    tail[n // 2:] = False
    for v in map(_t, (np.ones(n, bool), rng.random(n) < 0.5, tail, np.zeros(n, bool))):
        assert torch.equal(scan.plain(*planes, valid=v), base & v)
        assert torch.equal(mask_fn(*planes, valid=v), base & v)
        assert int(count_fn(*planes, valid=v)) == int((base & v).sum())
        assert torch.equal(m2(_t(hi), _t(lo), valid=v), base2 & v)
        assert int(c2(_t(hi), _t(lo), valid=v)) == int((base2 & v).sum())
