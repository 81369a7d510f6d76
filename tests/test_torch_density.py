"""Port parity for density: ``geomesa_tpu_torch``'s density kernel (its
plain version on the CPU), ``DeviceIndex.density`` and
``process.density.density`` against ``geomesa_tpu``'s.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
``build_density_pallas`` in interpret mode, called bare or inside
``DeviceIndex.density`` (which takes the XLA scatter past 512x512).
Inputs come from ``np.random.default_rng`` with float32-exact coordinates
and values. Tolerances: unweighted grids bit-exact; weighted grids within
rtol 2e-5 / atol 1e-3 (the counterpart's own bound: its MXU and scatter
sums run in float32, the port's in float64). The bare Pallas kernel
computes pixels in float32 (its viewport is a float32 array) while the
port computes them in float64, so those tests use pixel-centre data and
compare random data by total mass within 4 rows; through ``DeviceIndex``
both packages compute pixels in float64, so random data, border pixels
included, match bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.ops.density_pallas import build_density_pallas
from geomesa_tpu.ops.density_pallas import density_oracle as jax_oracle
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.ops.density import density_grid
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

ENV = np.array([-60.0, -45.0, 100.0, 60.0], np.float32)
DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
Z3_SPEC = "count:Int,val:Double,dtg:Date,name:String,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,val:Double,*geom:Point:srid=4326"
WEIGHTED = dict(rtol=2e-5, atol=1e-3)
ENV_EDGES = (-64.0, -32.0, 64.0, 32.0)  # (64, 32) cells of 2 x 2 degrees
ENV_WIDE = (-60.0, -45.0, 100.0, 60.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _center_data(n, seed, width, height):
    """Points at pixel centres: a pixel no engine can disagree on."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, width, n)
    py = rng.integers(0, height, n)
    x = ENV[0] + (px + 0.5) * (ENV[2] - ENV[0]) / width
    y = ENV[1] + (py + 0.5) * (ENV[3] - ENV[1]) / height
    m = (rng.random(n) < 0.7).astype(np.int8)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32), m, w


def _pallas(width, height, x, y, m, w=None):
    fn = build_density_pallas(width, height, w is not None)
    args = [jnp.asarray(ENV), jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)]
    if w is not None:
        args.append(jnp.asarray(w))
    return np.asarray(jax.jit(fn)(*args))


@pytest.mark.parametrize("wh", [(256, 256), (100, 37), (512, 64), (16, 16)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_plain_matches_pallas_on_pixel_centres(wh):
    width, height = wh
    x, y, m, w = _center_data(20000 if wh == (256, 256) else 5000, 3, width, height)
    mask = _t(m.astype(bool))
    got = density_grid(_t(x), _t(y), ENV, width, height, mask=mask).numpy()
    assert got.shape == (height, width)
    np.testing.assert_array_equal(got, _pallas(width, height, x, y, m))
    assert got.sum() == int(m.sum())  # every hit is inside
    got_w = density_grid(_t(x), _t(y), ENV, width, height, mask=mask, weights=_t(w)).numpy()
    np.testing.assert_allclose(got_w, _pallas(width, height, x, y, m, w), **WEIGHTED)


def test_outside_rows_and_empty():
    x = np.full(500, 150.0, np.float32)
    y = np.full(500, 80.0, np.float32)
    m = np.ones(500, np.int8)
    env = np.array([0, 0, 10, 10], np.float32)
    got = density_grid(_t(x), _t(y), env, 64, 64, mask=_t(m.astype(bool))).numpy()
    assert got.sum() == 0
    want = np.asarray(jax.jit(build_density_pallas(64, 64))(
        jnp.asarray(env), jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    e = np.empty(0, np.float32)
    got = density_grid(_t(e), _t(e), env, 64, 64).numpy()
    assert got.shape == (64, 64) and got.sum() == 0
    got_w = density_grid(_t(e), _t(e), env, 64, 64, weights=_t(e)).numpy()
    assert got_w.shape == (64, 64) and got_w.sum() == 0


def test_random_data_mass_close_to_pallas():
    """Borderline-bearing data: the float32 (Pallas) and float64 (port)
    pixel math may place a row one cell over, and a row on the viewport
    edge in or out, but total mass agrees within a handful of rows."""
    rng = np.random.default_rng(1)
    n = 50000
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-90, 90, n).astype(np.float32)
    m = (rng.random(n) < 0.5).astype(np.int8)
    got = density_grid(_t(x), _t(y), ENV, 256, 256, mask=_t(m.astype(bool))).numpy()
    want = _pallas(256, 256, x, y, m)
    assert abs(float(got.sum()) - float(want.sum())) <= 4
    # against the counterpart's float32 host reference: a row that moves
    # one cell over changes two cells by one
    assert np.abs(got - jax_oracle(x, y, m, None, ENV, 256, 256)).sum() <= 8


def test_bad_arguments_raise():
    x = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="no area"):
        density_grid(x, x, (0, 0, 0, 1), 8, 8)
    with pytest.raises(TypeError, match="float32"):
        density_grid(x.double(), x, ENV, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        density_grid(x, x, ENV, 8, 8, mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="cells"):
        density_grid(x, x, ENV, 1 << 16, 1 << 16)


# -- DeviceIndex.density in both packages -------------------------------------


def _near_edges(lo, hi, cells, rng, k):
    """k float32 values (as float64) on the cell edges of [lo, hi] cut into
    ``cells``, or one float32 ulp below or above one."""
    e = (lo + rng.integers(0, cells + 1, k) * (hi - lo) / cells).astype(np.float32)
    step = rng.integers(-1, 2, k)
    e = np.where(step < 0, np.nextafter(e, np.float32(-np.inf)), e)
    e = np.where(step > 0, np.nextafter(e, np.float32(np.inf)), e)
    return e.astype(np.float64)


def _columns(n, seed, with_dtg=True):
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-60, -40], [100, 55], (6, 2))
    xy = centres[rng.integers(0, 6, n)] + rng.normal(0, 3.0, (n, 2))
    uni = rng.uniform([-180, -90], [180, 90], (n, 2))
    xy = np.where(rng.uniform(size=(n, 1)) < 0.85, xy, uni)
    xy = np.clip(xy, [-180, -90], [180, 90])
    # rows on and one float32 ulp either side of the cell edges of the
    # grids below (where float32 and float64 pixel math part ways), and on
    # and just past the viewport border
    for i, (env, (w, h)) in enumerate((
        (ENV_EDGES, (64, 32)), (ENV_WIDE, (128, 64)), (ENV_WIDE, (600, 3)),
        (ENV_WIDE, (1024, 1024)),
    )):
        rows = slice(300 * i, 300 * (i + 1))
        xy[rows, 0] = _near_edges(env[0], env[2], w, rng, 300)
        xy[rows, 1] = _near_edges(env[1], env[3], h, rng, 300)
    xy[1200:1204] = [[-64, -32], [64, 32], [-64.0001, 0], [0, 32.0001]]
    cols = {
        "count": rng.integers(0, 1000, n),
        "val": rng.uniform(0.5, 2.0, n),
        "geom": xy.astype(np.float32).astype(np.float64),
    }
    cols["val"] = cols["val"].astype(np.float32).astype(np.float64)
    if with_dtg:
        cols["dtg"] = rng.integers(T0, T0 + 60 * DAY, n)
        cols["name"] = np.array(["a", "b", "c"] * (n // 3) + ["a"] * (n % 3), dtype=object)
    return cols


def _pair(spec, cols):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    jsft, sft = JSFT.create("t", spec), SimpleFeatureType.create("t", spec)
    jstore = JStore(JBatch.from_columns(jsft, cols))
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    jdi = JIndex(jstore, "t", z_planes=True)
    tdi = DeviceIndex(store, "t", z_planes=True, device="cpu")
    return jdi, tdi, jstore, store


@pytest.fixture(scope="module")
def z3():
    return _pair(Z3_SPEC, _columns(6007, seed=11))


@pytest.fixture(scope="module")
def z2():
    return _pair(Z2_SPEC, _columns(6007, seed=12, with_dtg=False))


BBOX = "BBOX(geom, -40, -30, 60, 40)"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-02-10T00:00:00Z"
Z3_CASES = [  # (filter, loose, envelope, (width, height), weight)
    ("INCLUDE", None, ENV_EDGES, (64, 32), None),
    (BBOX, None, ENV_WIDE, (128, 64), None),
    (f"{BBOX} AND {DURING}", False, ENV_EDGES, (64, 32), None),
    (f"{BBOX} AND {DURING}", True, ENV_EDGES, (64, 32), None),
    (f"{BBOX} AND {DURING}", False, ENV_WIDE, (600, 3), None),
    ("INCLUDE", None, ENV_WIDE, (1024, 1024), None),
    (BBOX, None, ENV_WIDE, (128, 64), "val"),
    (f"{BBOX} AND {DURING}", False, ENV_EDGES, (64, 32), "count"),
    ("INCLUDE", None, ENV_WIDE, (600, 3), "val"),
]
Z2_CASES = [
    ("INCLUDE", None, ENV_EDGES, (64, 32), None),
    (BBOX, True, ENV_WIDE, (128, 64), None),
    (BBOX, False, ENV_EDGES, (1024, 1024), None),
    (BBOX, False, ENV_EDGES, (64, 32), "count"),
]


def _assert_grids(got, want, weight):
    assert got is not None and want is not None
    assert got.shape == want.shape and got.dtype == np.float32
    if weight is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **WEIGHTED)


@pytest.mark.parametrize("case", Z3_CASES, ids=lambda c: f"{c[0][:12]}-{c[1]}-{c[3]}-{c[4]}")
def test_z3_density_matches(z3, case):
    jdi, tdi, _, _ = z3
    f, loose, env, (w, h), weight = case
    want = jdi.density(f, JEnvelope(*env), w, h, weight_attr=weight, loose=loose)
    got = tdi.density(f, Envelope(*env), w, h, weight_attr=weight, loose=loose)
    _assert_grids(got, want, weight)
    assert got.sum() > 0


@pytest.mark.parametrize("case", Z2_CASES, ids=lambda c: f"{c[0][:12]}-{c[1]}-{c[3]}-{c[4]}")
def test_z2_density_matches(z2, case):
    jdi, tdi, _, _ = z2
    f, loose, env, (w, h), weight = case
    want = jdi.density(f, JEnvelope(*env), w, h, weight_attr=weight, loose=loose)
    got = tdi.density(f, Envelope(*env), w, h, weight_attr=weight, loose=loose)
    _assert_grids(got, want, weight)


def test_density_none_returns(z3):
    jdi, tdi, _, _ = z3
    for f, weight in (
        (BBOX, "dtg"),  # int64: staged as __hi/__lo, no weight plane
        (BBOX, "nope"),
        (f"{BBOX} AND name LIKE 'a%'", None),  # host residual
    ):
        assert jdi.density(f, JEnvelope(*ENV_WIDE), 64, 32, weight_attr=weight) is None
        assert tdi.density(f, Envelope(*ENV_WIDE), 64, 32, weight_attr=weight) is None


def test_density_goes_through_the_kernel_wrappers(z3):
    """On CPU tensors the wrappers run the plain versions and count no
    launches; the exact filter never takes device_fn."""
    _, tdi, _, _ = z3
    kernels.reset_counts()
    tdi.density(f"{BBOX} AND {DURING}", Envelope(*ENV_WIDE), 64, 32)
    tdi.density("INCLUDE", Envelope(*ENV_WIDE), 64, 32, weight_attr="val")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels.DEVICE_FN_CALLS == {"count": 0, "mask": 0}


# -- process.density.density in both packages ---------------------------------


@pytest.mark.parametrize("weight", [None, "val"])
@pytest.mark.parametrize("path", ["resident", "store-device", "store-host"])
def test_process_density_matches(z3, path, weight):
    from geomesa_tpu.filter import ast as jast
    from geomesa_tpu.process.density import density as jdensity

    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.process.density import density

    jdi, tdi, jstore, store = z3
    env = ENV_WIDE
    if path == "resident":
        f = f"{BBOX} AND {DURING}"
        want = jdensity(jstore, "t", f, JEnvelope(*env), 128, 64,
                        weight_attr=weight, device_index=jdi)
        got = density(store, "t", f, Envelope(*env), 128, 64,
                      weight_attr=weight, device_index=tdi)
    else:
        use_device = path == "store-device"
        want = jdensity(jstore, "t", jast.Include, JEnvelope(*env), 128, 64,
                        weight_attr=weight, use_device=use_device)
        got = density(store, "t", ast.Include, Envelope(*env), 128, 64,
                      weight_attr=weight, use_device=use_device, device="cpu")
    _assert_grids(got, want, weight)


def test_process_density_refuses_query_objects(z3):
    from geomesa_tpu_torch.process.density import density

    _, tdi, _, store = z3
    with pytest.raises(TypeError, match="query plan"):
        density(store, "t", object(), Envelope(*ENV_WIDE), 8, 8, device_index=tdi)
