"""Port parity: the filter-scan encoder and its plain PyTorch version
against ``CompiledFilter.pallas_scan(interpret=True)`` of the JAX package.

Both sides read the same float32-staged columns (the JAX side through
``stage_columns(..., dtype=np.float32)``, since the JAX reference on the
CPU would otherwise compare float64 planes). For every filter the port
must refuse the kernel (``PallasUnsupported``) exactly where the JAX
package does; accepted filters must give the same count and mask, and
refused ones the same ``device_fn`` mask. Tolerance: bit-exact.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


@pytest.mark.parametrize("ecql", FILTERS[:12], ids=lambda s: s[:48])
def test_validity_is_the_plain_mask_anded(data, ecql):
    """The filter scan's plain version, count and mask with a validity
    plane equal the plain version without one ANDed with the plane (the
    device_fn route too, for a filter the encoder refuses)."""
    _, _, sft, batch = data
    tc = compile_filter(parse_ecql(ecql), sft)
    if not tc.device_cols:
        return
    tcols = stage_columns(batch, list(tc.device_cols), "cpu")
    n = len(batch)
    base = tc.mask(tcols)
    rng = np.random.default_rng(n)
    tail = np.ones(n, bool)
    tail[n // 2:] = False
    for v in map(torch.from_numpy, (np.ones(n, bool), rng.random(n) < 0.5, tail,
                                    np.zeros(n, bool))):
        assert torch.equal(tc.mask(tcols, valid=v), base & v)
        assert int(tc.count(tcols, valid=v)) == int((base & v).sum())
        if tc.program is not None:
            assert torch.equal(filter_scan.run_program_plain(tc.program, tcols, valid=v), base & v)


# -- the kernel wrapper's host logic (launch records, stage plans) -------------
#
# On the CPU a plane routes to the plain version, so these tests call the
# wrapper's record logic directly, with the routing and the SM count patched
# to what a card would give.


@pytest.fixture
def as_card(monkeypatch):
    monkeypatch.setattr(kernels, "on_cuda", lambda t: True)
    monkeypatch.setattr(filter_scan, "_sm_count", lambda dev: 132)


def _bbox_during(data):
    _, _, sft, batch = data
    cf = compile_filter(parse_ecql(
        "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-02-15T00:00:00Z"), sft)
    cols = stage_columns(batch, list(cf.device_cols), "cpu")
    return cf.program, [cols[c] for c in cf.program.cols]


def test_launch_record_is_reused_for_the_same_planes(data, as_card):
    prog, ts = _bbox_during(data)
    rec = filter_scan._record(prog, ts, None)
    assert filter_scan._record(prog, list(ts), None) is rec
    assert len(prog._records) == 1
    args = rec.args[1]
    assert [args.cols[i] for i in range(len(ts))] == [t.data_ptr() for t in ts]
    assert args.n == len(ts[0]) and args.n_cols == len(ts) and args.valid == 0
    assert args.prog == prog.device_words(ts[0].device).data_ptr()
    assert (args.rows, args.stages) == filter_scan.stage_plan(
        len(ts), prog.instr.size + prog.consts.size, False, True)[:2]


def test_launch_record_misses_on_a_new_dtype_at_the_same_pointer(data, as_card):
    prog, ts = _bbox_during(data)
    filter_scan._record(prog, ts, None)
    i = prog.cols.index("geom__x")
    view = ts[i].view(torch.int32)  # the float plane's pointer, another dtype
    assert view.data_ptr() == ts[i].data_ptr()
    with pytest.raises(TypeError, match="geom__x"):
        filter_scan._record(prog, ts[:i] + [view] + ts[i + 1:], None)
    assert len(prog._records) == 1


def test_launch_record_misses_on_a_new_shape_or_stride(data, as_card):
    prog, ts = _bbox_during(data)
    rec = filter_scan._record(prog, ts, None)
    short = [t[:-4] for t in ts]  # the same pointers, 4 rows fewer
    rec2 = filter_scan._record(prog, short, None)
    assert rec2 is not rec and rec2.n == rec.n - 4
    with pytest.raises(ValueError, match="shape"):
        filter_scan._record(prog, ts[:1] + short[1:], None)
    with pytest.raises(ValueError, match="contiguous"):
        filter_scan._record(prog, [t[::2] for t in ts], None)
    assert len(prog._records) == 2


def test_launch_record_misses_on_another_validity_plane(data, as_card):
    prog, ts = _bbox_during(data)
    n = len(ts[0])
    plain = filter_scan._record(prog, ts, None)
    v1 = torch.ones(n, dtype=torch.bool)
    v2 = torch.zeros(n, dtype=torch.bool)
    r1 = filter_scan._record(prog, ts, v1)
    r2 = filter_scan._record(prog, ts, v2)
    assert len({id(plain), id(r1), id(r2)}) == 3
    assert r1.valid and r2.valid and not plain.valid
    assert (r1.args[1].valid, r2.args[1].valid) == (v1.data_ptr(), v2.data_ptr())
    assert filter_scan._record(prog, ts, v1) is r1
    with pytest.raises(ValueError, match="4-byte aligned"):
        filter_scan._record(prog, ts, torch.ones(n + 1, dtype=torch.bool)[1:])
    with pytest.raises(ValueError, match="rows"):
        filter_scan._record(prog, ts, v1[:-1])


def test_launch_record_misses_on_another_program(data, as_card):
    prog, ts = _bbox_during(data)
    _, _, sft, batch = data
    other = compile_filter(parse_ecql("count > 50 AND score <= 0.25"), sft).program
    cols = stage_columns(batch, list(other.cols), "cpu")
    rec = filter_scan._record(prog, ts, None)
    rec2 = filter_scan._record(other, [cols[c] for c in other.cols], None)
    assert rec2 is not rec and len(prog._records) == len(other._records) == 1
    assert rec2.args[0].prog == other.device_words(ts[0].device).data_ptr()


def test_a_bad_plane_raises_on_the_call_after_a_good_one(data, as_card):
    prog, ts = _bbox_during(data)
    rec = filter_scan._record(prog, ts, None)
    shifted = [torch.cat([t[:1], t])[1:] for t in ts]  # 4 bytes into their buffers
    with pytest.raises(ValueError, match="16-byte aligned"):
        filter_scan._record(prog, shifted, None)
    with pytest.raises(ValueError, match="16-byte aligned"):  # still, on a second call
        filter_scan._record(prog, shifted, None)
    wide = [t.to(torch.float64) if t.dtype == torch.float32 else t for t in ts]
    with pytest.raises(TypeError):
        filter_scan._record(prog, wide, None)
    assert filter_scan._record(prog, ts, None) is rec
    with pytest.raises(KeyError):
        filter_scan.filter_scan_mask(prog, {c: t for c, t in zip(prog.cols[1:], ts[1:])})


def test_launch_records_stay_bounded_over_staged_runs(data, as_card):
    """A store query stages new planes every run: the records of one
    program stay at most RECORDS_PER_PROGRAM, and none keeps a plane
    alive."""
    import gc
    import weakref

    prog, ts = _bbox_during(data)
    refs = []
    # every turn's planes stay alive until the loop ends: freed clones
    # would let the allocator hand a later turn the same addresses, and a
    # record keyed by the same address, dtype, shape and stride is rightly
    # the same record
    turns = []
    for _ in range(5 * filter_scan.RECORDS_PER_PROGRAM):
        staged = [t.clone() for t in ts]
        filter_scan._record(prog, staged, None)
        turns.append(staged)
        refs += [weakref.ref(t) for t in staged]
        assert len(prog._records) <= filter_scan.RECORDS_PER_PROGRAM
    del staged, turns
    gc.collect()
    assert len(prog._records) == filter_scan.RECORDS_PER_PROGRAM
    assert all(r() is None for r in refs)


def test_launch_struct_matches_the_c_layout():
    """``_Launch`` mirrors csrc/filter_scan.cu's FilterScanLaunch, field
    for field (ctypes passes the structure's address)."""
    import re

    src = (Path(filter_scan.__file__).resolve().parents[1] / "csrc" / "filter_scan.cu").read_text()
    body = re.search(r"struct FilterScanLaunch \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"\[.*\]", "", v).strip().split()[-1] for v in decl.split(",")]
    assert names == [f for f, _ in filter_scan._Launch._fields_]


@pytest.mark.parametrize("valid", [False, True], ids=["no plane", "plane"])
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4, 6, 8, 16, 32, 48, 63, 64])
def test_stage_plan_fits_every_legal_program(n_cols, valid):
    """For 1-64 columns and up to 12288 words, with and without a plane,
    count and mask: the chosen layout fits one block's 227 KB and the
    chosen blocks' share of an SM, with at least 2 stages of a whole
    number of 32-row groups (128 bytes of a column)."""
    for words in (9, 64, 500, 1000, 4096, 8000, 12287, filter_scan.MAX_PROGRAM_WORDS):
        for mask in (False, True):
            rows, stages, per_sm = filter_scan.stage_plan(n_cols, words, valid, mask)
            smem = filter_scan.stage_smem(n_cols, words, rows, stages, valid, mask)
            assert stages >= 2 and rows >= 32 and rows % 32 == 0
            assert smem <= filter_scan.SMEM_PER_BLOCK
            assert per_sm * (smem + filter_scan.SMEM_RESERVED) <= filter_scan.SMEM_PER_SM
            assert per_sm == 1 or rows >= 1024


@given(st.integers(1, 64), st.integers(9, filter_scan.MAX_PROGRAM_WORDS), st.booleans(),
       st.booleans())
@settings(max_examples=300, deadline=None)
def test_stage_plan_property(n_cols, words, valid, mask):
    rows, stages, per_sm = filter_scan.stage_plan(n_cols, words, valid, mask)
    smem = filter_scan.stage_smem(n_cols, words, rows, stages, valid, mask)
    assert stages >= 2 and rows % 32 == 0
    assert per_sm * (smem + filter_scan.SMEM_RESERVED) <= filter_scan.SMEM_PER_SM
    # the plan takes the most rows a stage that fits with two stages or more
    if rows < 4096 and per_sm == 1:
        assert filter_scan.stage_smem(n_cols, words, 2 * rows, 2, valid, mask) > filter_scan.SMEM_PER_BLOCK


def test_launch_records_under_threads(data, as_card, monkeypatch):
    """8 threads build and look up records of one program at once, as the
    scheduler's workers launch: every record points at the one program
    buffer the Program keeps (a second buffer, built by a racing thread
    and dropped, once gave the card wrong masks), each record's pointers
    are its own planes', and the cache stays bounded. Building the
    program's words sleeps, so that threads do race to build them."""
    import sys
    import threading
    import time

    words = filter_scan.Program.words
    monkeypatch.setattr(filter_scan.Program, "words",
                        lambda self: (time.sleep(0.01), words(self))[1])
    _, _, sft, batch = data
    prog = compile_filter(parse_ecql("count > 50 AND score <= 0.25"), sft).program
    cols = stage_columns(batch, list(prog.cols), "cpu")
    shared = [cols[c] for c in prog.cols]
    start, bad, recs = threading.Barrier(8), [], []

    def work(i):
        start.wait()
        for j in range(200):
            ts = shared if j % 2 else [t.clone() for t in shared]
            rec = filter_scan._record(prog, ts, None)
            recs.append(rec)
            if [rec.args[1].cols[k] for k in range(len(ts))] != [t.data_ptr() for t in ts]:
                bad.append((i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and len(recs) == 8 * 200
    buf = prog.device_words(shared[0].device).data_ptr()
    assert {r.args[0].prog for r in recs} == {r.args[1].prog for r in recs} == {buf}
    assert len(prog._records) <= filter_scan.RECORDS_PER_PROGRAM
