"""Port parity: the filter-scan encoder and its plain PyTorch version
against ``CompiledFilter.pallas_scan(interpret=True)`` of the JAX package.

Both sides read the same float32-staged columns (the JAX side through
``stage_columns(..., dtype=np.float32)``, since the JAX reference on the
CPU would otherwise compare float64 planes). For every filter the port
must refuse the kernel (``PallasUnsupported``) exactly where the JAX
package does; accepted filters must give the same count and mask, and
refused ones the same ``device_fn`` mask. Tolerance: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.filter.compile import compile_filter as jcompile
from geomesa_tpu.filter.ecql import parse_ecql as jparse
from geomesa_tpu.ops.scan import stage_columns as jstage
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.ops import filter_scan
from geomesa_tpu_torch.ops.scan import stage_columns

torch.set_num_threads(2)  # xdist workers share the host's cores

SPEC = "count:Int,score:Float,dtg:Date,name:String,dbl:Double,*geom:Point:srid=4326"
T0 = 1_577_836_800_000  # 2020-01-01 in epoch-ms
W32 = 1 << 32


def _ring(k, cx=10.0, cy=20.0, r=15.0):
    """Closed k-edge polygon ring as WKT coordinates."""
    a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    pts = [(cx + r * np.cos(t) * (1.0 + 0.3 * (i % 3)), cy + r * np.sin(t))
           for i, t in enumerate(a)]
    pts.append(pts[0])
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


FILTERS = [
    # the JAX package's own Pallas test set (tests/test_pallas_scan.py)
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND "
    "dtg DURING 2020-01-10T00:00:00Z/2020-02-15T00:00:00Z",
    "count > 50 AND score <= 0.25",
    "count BETWEEN 10 AND 20 OR NOT BBOX(geom, 0, 0, 90, 45)",
    "count IN (1, 2, 3, 42)",
    "dtg > '2020-02-01T00:00:00Z'",
    "INTERSECTS(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0)))",
    "DWITHIN(geom, POINT(5 45), 10, kilometers)",
    # float32 rounding of literals, bounds on data points
    "BBOX(geom, 0.1, 0.2, 0.30000001, 0.7)",
    "score > 0.1 AND score < 0.9",
    "score BETWEEN 0.25 AND 0.75",
    "DWITHIN(geom, POINT(5 45), 1000, kilometers)",
    "DWITHIN(geom, POLYGON((0 0, 10 0, 10 10, 0 10, 0 0)), 2, kilometers)",
    # polygons: 5 edges, 64 edges (the kernel budget), 65 (refused)
    "DISJOINT(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0)))",
    f"INTERSECTS(geom, POLYGON(({_ring(64)})))",
    f"DISJOINT(geom, POLYGON(({_ring(64)})))",
    f"WITHIN(geom, POLYGON(({_ring(65)})))",
    "INTERSECTS(geom, MULTIPOLYGON(((0 0, 40 0, 40 40, 0 40, 0 0), "
    "(10 10, 20 10, 20 20, 10 20, 10 10)), ((-50 -50, -40 -50, -45 -40, -50 -50))))",
    "INTERSECTS(geom, ENVELOPE(-20, 20, -10, 30))",
    # int32 column: non-integer literals promote, big ints wrap
    "count > 50.5",
    "count = 50.0 OR count = 7.5",
    "count <> 12.5",
    "count <= 1e20 AND count > -1e20",
    "count IN (1, 2.5, 3.0, 4294967297)",
    "count BETWEEN 10.5 AND 20.5",
    "count >= 4294967296",
    "count < 3000000000",
    # int64 lanes across word boundaries
    f"dtg BETWEEN {W32 - 1} AND {2 * W32}",
    f"dtg BETWEEN -{W32} AND 0",
    f"dtg > {W32 - 0.5}",
    "dtg = 5.5 OR dtg <> 7.5",
    f"dtg IN ({W32}, 1.5, -1)",
    f"dtg <= {3 * W32 + 0.25}",
    # logic
    "NOT (count < 20 OR score > 0.5) AND NOT NOT BBOX(geom, -90, -45, 90, 45)",
    "INCLUDE",
    "EXCLUDE OR count = 3",
    # residual splits and refusals
    "BBOX(geom, -10, 35, 30, 60) AND name LIKE 'a%'",
    "CONTAINS(geom, POLYGON((-10 0, 40 10, 20 50, -30 40, -10 0))) AND count > 3",
    "dbl > 0.5",
    "dbl > 0.5 AND BBOX(geom, -10, 35, 30, 60)",
]


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-60, 60, n).astype(np.float32).astype(np.float64)
    y = rng.uniform(-60, 60, n).astype(np.float32).astype(np.float64)
    # data ON bounds and vertices of the filters above
    x[:6] = [0.1, 0.30000001, -10.0, 40.0, 20.0, 10.0]
    y[:6] = [0.2, 0.7, 35.0, 10.0, 50.0, 20.0]
    dtg = rng.integers(T0, T0 + 60 * 86400_000, n)
    dtg[:8] = [W32 - 1, W32, W32 + 1, 2 * W32, -W32, -1, 0, 3 * W32]
    count = rng.integers(0, 100, n)
    count[:3] = [0, 2**31 - 1, -(2**31)]
    return {
        "count": count,
        "score": rng.uniform(0, 1, n),
        "dtg": dtg,
        "name": np.array(["ab", "ba", "a", "b"] * (n // 4) + ["a"] * (n % 4), dtype=object),
        "dbl": rng.uniform(0, 1, n),
        "geom": np.stack([x, y], axis=1),
    }


@pytest.fixture(scope="module")
def data():
    cols = _columns(3001, seed=3)
    jsft = JSFT.create("t", SPEC)
    sft = SimpleFeatureType.create("t", SPEC)
    return (
        jsft, JBatch.from_columns(jsft, cols),
        sft, FeatureBatch.from_columns(sft, cols),
    )


@pytest.mark.parametrize("ecql", FILTERS, ids=lambda s: s[:48])
def test_kernel_program_matches_pallas_interpret(data, ecql):
    jsft, jbatch, sft, batch = data
    jc = jcompile(jparse(ecql), jsft)
    tc = compile_filter(parse_ecql(ecql), sft)
    assert repr(tc.device_part) == repr(jc.device_part)
    assert tc.device_cols == jc.device_cols
    jscan = jc.pallas_scan(interpret=True, block_rows=32)
    # the port refuses the kernel exactly where the JAX package does
    assert (tc.program is None) == (jscan is None)
    if not tc.device_cols:
        return
    jcols = jstage(jbatch, list(jc.device_cols), dtype=np.float32)
    tcols = stage_columns(batch, list(tc.device_cols), "cpu")
    n = len(batch)
    before = dict(kernels.DEVICE_FN_CALLS)
    got_m = tc.mask(tcols).numpy()
    got_c = tc.count(tcols)
    assert got_c.dtype == torch.int32 and got_m.dtype == np.bool_
    if jscan is None:
        want_m = np.asarray(jc.device_fn(jcols))
        want_c = int(jnp.sum(jc.device_fn(jcols)))
        assert kernels.DEVICE_FN_CALLS["mask"] == before["mask"] + 1
        assert kernels.DEVICE_FN_CALLS["count"] == before["count"] + 1
    else:
        want_c = int(jscan[0](jcols))
        want_m = np.asarray(jscan[1](jcols))[:n]
        assert kernels.DEVICE_FN_CALLS == before
    np.testing.assert_array_equal(got_m, want_m)
    assert int(got_c) == want_c


@pytest.mark.parametrize("ecql", FILTERS, ids=lambda s: s[:48])
def test_refusal_messages_match(data, ecql):
    """Where both refuse, they refuse for the same reason."""
    from geomesa_tpu.ops.pallas_scan import PallasUnsupported as JUnsupported
    from geomesa_tpu.ops.pallas_scan import build_pallas_scan

    jsft, _, sft, _ = data
    jc = jcompile(jparse(ecql), jsft)
    tc = compile_filter(parse_ecql(ecql), sft)
    try:
        build_pallas_scan(jc.device_part, jsft, interpret=True)
        want = None
    except JUnsupported as e:
        want = str(e)
    try:
        filter_scan.encode_kernel_program(tc.device_part, sft)
        got = None
    except filter_scan.PallasUnsupported as e:
        got = str(e)
    assert got == want


def test_envelope_bbox_on_non_point_planes():
    """Non-point BBOX/DWITHIN read the envelope planes (the JAX kernel
    delegates them to the XLA function); held against it on planes given
    directly, since this slice stages no non-point data."""
    from geomesa_tpu.ops.pallas_scan import build_pallas_scan

    spec = "*geom:Polygon:srid=4326"
    jsft, sft = JSFT.create("p", spec), SimpleFeatureType.create("p", spec)
    rng = np.random.default_rng(9)
    n = 777
    x0 = rng.uniform(-50, 50, n).astype(np.float32)
    y0 = rng.uniform(-50, 50, n).astype(np.float32)
    planes = {
        "geom__x0": x0, "geom__y0": y0,
        "geom__x1": x0 + rng.uniform(0, 5, n).astype(np.float32),
        "geom__y1": y0 + rng.uniform(0, 5, n).astype(np.float32),
    }
    for ecql in (
        "BBOX(geom, -10.1, 35, 30, 60)",
        "DWITHIN(geom, POINT(1 2), 300, kilometers)",
    ):
        jf, tf = jparse(ecql), parse_ecql(ecql)
        count_fn, mask_fn, cols = build_pallas_scan(jf, jsft, block_rows=32, interpret=True)
        jcols = {c: jnp.asarray(planes[c]) for c in cols}
        prog = filter_scan.encode_kernel_program(tf, sft)
        tcols = {c: torch.from_numpy(planes[c]) for c in prog.cols}
        np.testing.assert_array_equal(
            filter_scan.filter_scan_mask(prog, tcols).numpy(),
            np.asarray(mask_fn(jcols))[:n],
        )
        assert int(filter_scan.filter_scan_count(prog, tcols)) == int(count_fn(jcols))


def test_wrapper_checks_plane_dtypes(data):
    _, _, sft, batch = data
    tc = compile_filter(parse_ecql("BBOX(geom, -10, 35, 30, 60)"), sft)
    tcols = stage_columns(batch, list(tc.device_cols), "cpu")
    tcols["geom__x"] = tcols["geom__x"].to(torch.float64)
    with pytest.raises(TypeError):
        tc.count(tcols)


@pytest.mark.parametrize("op", ["=", "<>", "<", "<=", ">", ">="])
def test_int64_lane_compare_matches_jax(op):
    from geomesa_tpu.ops.int64lanes import cmp_jax
    from geomesa_tpu.ops.int64lanes import split_array_np as jsplit

    from geomesa_tpu_torch.ops import int64lanes

    vals = np.array(
        [-(2**63), -W32 - 1, -W32, -1, 0, 1, W32 - 1, W32, W32 + 1, 2**63 - 1],
        np.int64,
    )
    jh, jl = jsplit(vals)
    th, tl = int64lanes.split_array_np(vals)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)
    for v in (-(2**63), -W32, -1, 0, W32 - 1, W32, 2**62):
        want = np.asarray(cmp_jax(op, jnp.asarray(jh), jnp.asarray(jl), v))
        got = int64lanes.cmp(op, torch.from_numpy(th), torch.from_numpy(tl), v)
        np.testing.assert_array_equal(got.numpy(), want)
