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
    """A ``Query`` is the process's input now, as in the JAX package (its
    auths hint wins). An object that is neither a Query nor a filter
    raises in both packages: the port's index refuses it (TypeError); the
    JAX package's index declines it and its BatchStore refuses the filter
    (NotImplementedError)."""
    from geomesa_tpu.process.density import density as jdensity
    from geomesa_tpu.query.plan import Query as JQuery
    from geomesa_tpu_torch.process.density import density
    from geomesa_tpu_torch.query.plan import Query

    jdi, tdi, jstore, store = z3
    with pytest.raises(TypeError):
        density(store, "t", object(), Envelope(*ENV_WIDE), 8, 8, device_index=tdi)
    with pytest.raises(NotImplementedError):
        jdensity(jstore, "t", object(), JEnvelope(*ENV_WIDE), 8, 8, device_index=jdi)
    q = f"{BBOX} AND {DURING}"
    got = density(store, "t", Query(filter=q), Envelope(*ENV_WIDE), 64, 32, device_index=tdi)
    want = jdensity(jstore, "t", JQuery(filter=q), JEnvelope(*ENV_WIDE), 64, 32, device_index=jdi)
    np.testing.assert_array_equal(got, np.asarray(want))


# -- viewports without area ----------------------------------------------------

INVERTED = (170.0, -10.0, -170.0, 10.0)  # a map tile across the antimeridian
DEGENERATE = [INVERTED, (0.0, 0.0, 0.0, 10.0), (0.0, 0.0, 10.0, 0.0), (0.0, 0.0, 0.0, 0.0)]
DEGENERATE_IDS = ["inverted", "zero-width", "zero-height", "point"]


def _line_columns(n, seed, with_dtg=True):
    """``_columns`` with rows on the lines x = 0 and y = 0 (inside and
    outside the viewports below), on the point (0, 0), on the corners of
    the segments, and near the antimeridian."""
    cols = _columns(n, seed, with_dtg)
    rng = np.random.default_rng(seed + 1)
    xy = cols["geom"]
    k = 40
    xy[2000:2000 + k] = np.stack([np.zeros(k), rng.uniform(-5, 15, k)], 1)
    xy[2100:2100 + k] = np.stack([rng.uniform(-5, 15, k), np.zeros(k)], 1)
    xy[2200:2205] = [[0, 0], [0, 0], [0, 10], [10, 0], [0, -1e-3]]
    xy[2300:2300 + k] = np.stack([rng.uniform(170, 180, k), rng.uniform(-10, 10, k)], 1)
    cols["geom"] = xy.astype(np.float32).astype(np.float64)
    return cols


@pytest.fixture(scope="module")
def lines_z3():
    return _pair(Z3_SPEC, _line_columns(3001, seed=21))


@pytest.fixture(scope="module")
def lines_z2():
    return _pair(Z2_SPEC, _line_columns(3001, seed=22, with_dtg=False))


@pytest.mark.parametrize("env", DEGENERATE, ids=DEGENERATE_IDS)
@pytest.mark.parametrize("wh", [(8, 4), (600, 3)], ids=["8x4", "600x3"])
@pytest.mark.parametrize("weight", [None, "val"])
@pytest.mark.parametrize("kind", ["z3", "z2"])
def test_degenerate_viewport_density_matches(lines_z3, lines_z2, kind, weight, wh, env):
    """Inverted viewports give a zero grid; a viewport of zero width or
    height counts the rows on its line in cell 0 of that axis, as the
    counterpart's NaN pixel coordinate lands there (its Pallas engine at
    8x4, its scatter engine at 600x3)."""
    jdi, tdi, _, _ = lines_z3 if kind == "z3" else lines_z2
    f = f"{BBOX} AND {DURING}" if kind == "z3" else BBOX
    want = jdi.density(f, JEnvelope(*env), *wh, weight_attr=weight, loose=False)
    got = tdi.density(f, Envelope(*env), *wh, weight_attr=weight, loose=False)
    _assert_grids(got, want, weight)
    if env == INVERTED:
        assert not got.any()
    else:
        assert got.sum() > 0  # rows on the line count
        nz = np.argwhere(got)
        assert (nz[:, 1] == 0).all() if env[2] == env[0] else True
        assert (nz[:, 0] == 0).all() if env[3] == env[1] else True


@pytest.mark.parametrize("env", DEGENERATE, ids=DEGENERATE_IDS)
def test_degenerate_viewport_loose_and_include(lines_z3, env):
    jdi, tdi, _, _ = lines_z3
    for f, loose in (("INCLUDE", None), (f"{BBOX} AND {DURING}", True)):
        want = jdi.density(f, JEnvelope(*env), 16, 16, loose=loose)
        got = tdi.density(f, Envelope(*env), 16, 16, loose=loose)
        _assert_grids(got, want, None)
    # a filter the device cannot answer: None in both, inverted or not
    f = f"{BBOX} AND name LIKE 'a%'"
    assert jdi.density(f, JEnvelope(*env), 16, 16) is None
    assert tdi.density(f, Envelope(*env), 16, 16) is None


@pytest.mark.parametrize("env", DEGENERATE, ids=DEGENERATE_IDS)
@pytest.mark.parametrize("weight", [None, "val"])
@pytest.mark.parametrize("path", ["resident", "store-device", "store-host"])
def test_degenerate_viewport_process_density_matches(lines_z3, path, weight, env):
    """``process.density.density``: the resident path answers as
    ``DeviceIndex.density``; the store path gives a zero grid for an
    inverted viewport, as the counterpart's does. For one of zero width or
    height the counterpart's host and device store paths raise
    ZeroDivisionError; the port's store path answers there with the
    resident rung's grid, the counterpart's resident answer for the same
    filter (ROADMAP section 3, reference faults the port does not copy)."""
    from geomesa_tpu.filter import ast as jast
    from geomesa_tpu.process.density import density as jdensity

    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.process.density import density

    jdi, tdi, jstore, store = lines_z3
    if path == "resident":
        jkw, kw = dict(device_index=jdi), dict(device_index=tdi)
        jf, f = BBOX, BBOX
    else:
        use_device = path == "store-device"
        jkw, kw = dict(use_device=use_device), dict(use_device=use_device, device="cpu")
        jf, f = jast.Include, ast.Include
    try:
        want = jdensity(jstore, "t", jf, JEnvelope(*env), 32, 16, weight_attr=weight, **jkw)
    except ZeroDivisionError:
        assert path != "resident" and env != INVERTED
        want = jdensity(jstore, "t", jf, JEnvelope(*env), 32, 16, weight_attr=weight,
                        device_index=jdi)
        assert want.sum() > 0  # rows on the line count
    got = density(store, "t", f, Envelope(*env), 32, 16, weight_attr=weight, **kw)
    _assert_grids(got, want, weight)


def test_density_grid_lines_argument():
    """The ops layer counts rows on a line only when asked (the entry
    points ask); an inverted viewport raises even then."""
    x = torch.tensor([0.0, 0.0, 0.0, 8.0, 5.0], dtype=torch.float32)
    y = torch.tensor([0.0, 5.0, 10.0, 5.0, 11.0], dtype=torch.float32)
    got = density_grid(x, y, (0, 0, 0, 10), 4, 2, lines=True).numpy()
    np.testing.assert_array_equal(got, [[1, 0, 0, 0], [2, 0, 0, 0]])
    got = density_grid(x, y, (0, 5, 10, 5), 4, 2, lines=True,
                       weights=torch.tensor([1, 2, 4, 8, 16], dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, [[2, 0, 0, 8], [0, 0, 0, 0]])
    with pytest.raises(ValueError, match="no area"):
        density_grid(x, y, INVERTED, 4, 2, lines=True)


# -- non-finite weights ----------------------------------------------------------


def test_non_finite_weights_stay_in_the_cells_of_rows_that_count():
    """NaN and +-inf weights on masked-out rows and on rows outside the
    viewport change nothing; on rows inside, only their own cells go
    non-finite. Held against numpy's float64 scatter (the counterpart's
    Pallas engine spreads such a weight over a whole grid row)."""
    rng = np.random.default_rng(5)
    n, width, height = 4000, 64, 32
    x0, y0, x1, y1 = ENV_WIDE
    x = rng.uniform(x0 - 20, x1 + 20, n).astype(np.float32)
    y = rng.uniform(y0 - 20, y1 + 20, n).astype(np.float32)
    m = rng.random(n) < 0.6
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    bad = [np.nan, np.inf, -np.inf]
    for sel in (~m & inside, m & ~inside, ~m & ~inside):  # rows that do not count
        rows = np.nonzero(sel)[0][:3]
        w[rows] = bad
    counting = np.nonzero(m & inside)[0][:3]
    w[counting] = bad
    sx, sy = width / (x1 - x0), height / (y1 - y0)
    px = np.clip(np.floor((x.astype(np.float64) - x0) * sx), 0, width - 1).astype(np.int64)
    py = np.clip(np.floor((y.astype(np.float64) - y0) * sy), 0, height - 1).astype(np.int64)
    keep = m & inside
    want = np.zeros(width * height)
    np.add.at(want, (py * width + px)[keep], w[keep].astype(np.float64))
    want = want.reshape(height, width).astype(np.float32)
    with np.errstate(invalid="ignore"):
        got = density_grid(_t(x), _t(y), ENV_WIDE, width, height, mask=_t(m), weights=_t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bad_cells = {(int(py[i]), int(px[i])) for i in counting}
    assert {tuple(c) for c in np.argwhere(~np.isfinite(got))} == bad_cells


def test_non_finite_weights_resident_match_the_scatter_engine():
    """The same through ``DeviceIndex.density`` against the counterpart's
    scatter engine (its grids past 512 cells wide) and numpy."""
    cols = _columns(3001, seed=31)
    cols["geom"][[5, 9, 13]] = [[10.25, 5.25], [20.75, -10.5], [-35.25, 30.75]]  # inside
    cols["val"][[5, 9, 13]] = [np.nan, np.inf, -np.inf]
    cols["geom"][[20, 21, 22]] = [[170.0, 80.0], [-170.0, -80.0], [179.0, 0.0]]  # outside
    cols["val"][[20, 21, 22]] = [np.nan, np.inf, -np.inf]
    jdi, tdi, _, _ = _pair(Z3_SPEC, cols)
    for f in ("INCLUDE", BBOX):
        want = jdi.density(f, JEnvelope(*ENV_WIDE), 600, 3, weight_attr="val")
        got = tdi.density(f, Envelope(*ENV_WIDE), 600, 3, weight_attr="val")
        _assert_grids(got, want, "val")
        xy = cols["geom"]
        x0, y0, x1, y1 = ENV_WIDE
        sel = (xy[:, 0] >= x0) & (xy[:, 0] <= x1) & (xy[:, 1] >= y0) & (xy[:, 1] <= y1)
        if f == BBOX:
            sel &= (xy[:, 0] >= -40) & (xy[:, 0] <= 60) & (xy[:, 1] >= -30) & (xy[:, 1] <= 40)
        assert sel[[5, 9, 13]].all() and not sel[[20, 21, 22]].any()
        bad_cells = {(int(np.floor((xy[i, 1] - y0) * 3 / (y1 - y0))),
                      int(np.floor((xy[i, 0] - x0) * 600 / (x1 - x0)))) for i in (5, 9, 13)}
        assert {tuple(c) for c in np.argwhere(~np.isfinite(got))} == bad_cells
