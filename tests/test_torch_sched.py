"""The device query scheduler and its fused loose paths in
``geomesa_tpu_torch`` against ``geomesa_tpu``'s.

The same numpy columns go into both packages' ``DeviceIndex(z_planes=True)``
(the port's on ``device="cpu"``, where the batched kernel wrappers run
their plain versions) on every key layout the fused paths serve: z3 and z2
dim planes, the interleaved z3 and z2 keys, xz2 and xz3. Coordinates and
query bounds are exact in float32 and every row dates after 1970 (a row in
bin -1 is the one place where the packages differ: see
``test_bin_before_1970_never_matches_padding``). Checked, bit for bit: the
fused counts and fid sets equal the JAX package's and the port's own
serial loose answers at Q in {1, 3, 8} (the JAX package pads 3 to 4, the
port launches 3), each decline rule
returns None in both, and the batched plain versions equal per-query
loops of the single-query plain versions. Then the scheduler semantics of
``tests/test_sched.py`` and the scheduler tests of
``tests/test_resilience.py``, ported: fusion, backpressure, deadlines,
lanes and tenant fairness, the watchdog, exactly-once completion, the
worker-crash failpoint and the Retry-After jitter.
"""

import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import failpoints, kernels, ledger, metrics, resilience, tracing
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.ops import zscan
from geomesa_tpu_torch.sched import (
    LANE_BATCH,
    DeadlineExpired,
    FusableQuery,
    QueryScheduler,
    RejectedError,
    SchedConfig,
)
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
POINT3 = "name:String,dtg:Date,*geom:Point:srid=4326"
POINT2 = "name:String,*geom:Point:srid=4326"
XZ3 = "name:String,dtg:Date,*geom:Polygon:srid=4326"
XZ2 = "name:String,*geom:Polygon:srid=4326"


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def _points(n, seed, with_dtg=True):
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-50, -40], [50, 40], (6, 2))
    xy = centers[rng.integers(0, 6, n)] + rng.normal(0, 3.0, (n, 2))
    xy = np.clip(xy, [-180, -90], [180, 90]).astype(np.float32).astype(np.float64)
    cols = {"name": np.array(["a", "b"] * (n // 2) + ["a"] * (n % 2), dtype=object), "geom": xy}
    if with_dtg:
        cols["dtg"] = rng.integers(T0, T0 + 60 * DAY, n)
    return cols, centers


def _polygons(n, seed, with_dtg=True):
    """Rectangles and triangles with float32-exact corners (1/16 deg)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-50, -40], [50, 40], (6, 2))
    xy = centers[rng.integers(0, 6, n)] + rng.normal(0, 3.0, (n, 2))
    x = np.round(np.clip(xy[:, 0], -60, 58) * 16) / 16
    y = np.round(np.clip(xy[:, 1], -45, 43) * 16) / 16
    w = np.round(rng.uniform(0.0625, 2.0, n) * 16) / 16
    h = np.round(rng.uniform(0.0625, 2.0, n) * 16) / 16
    wkt = [f"POLYGON (({a} {b}, {a + c} {b}, {a + c} {b + d}, {a} {b + d}, {a} {b}))" if i % 3
           else f"POLYGON (({a} {b}, {a + c} {b}, {a} {b + d}, {a} {b}))"
           for i, (a, b, c, d) in enumerate(zip(x, y, w, h))]
    cols = {"name": np.array(["a", "b"] * (n // 2) + ["a"] * (n % 2), dtype=object),
            "geom": np.array(wkt, dtype=object)}
    if with_dtg:
        cols["dtg"] = rng.integers(T0, T0 + 60 * DAY, n)
    return cols, centers


def _pair(spec, cols, dim_planes=None):
    jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("t", spec), dict(cols))), "t",
                 z_planes=True, dim_planes=dim_planes)
    tdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", spec),
                                                           dict(cols))),
                      "t", z_planes=True, dim_planes=dim_planes, device="cpu")
    return jdi, tdi


def _tiles(centers, dated, k=8):
    """A map client's pans: tiles of 1-8 deg around the centres; dated
    tiles over windows of 1 to 20 days (1 to 4 week bins)."""
    out = []
    for i in range(k):
        cx, cy = centers[i % len(centers)]
        s = (8.0, 1.0, 4.0, 2.0)[i % 4]
        x0, y0 = cx - s / 2 + (i // 4), cy - s / 2
        q = f"BBOX(geom, {x0:.2f}, {y0:.2f}, {x0 + s:.2f}, {y0 + s:.2f})"
        if dated:
            d0 = T0 + (3 + 5 * i) * DAY
            q += f" AND dtg DURING {_iso(d0)}/{_iso(d0 + (20, 1, 13, 6)[i % 4] * DAY)}"
        out.append(q)
    return out


KINDS = {
    "z3_dim": (POINT3, _points, None, "dim", "z3"),
    "z2_dim": (POINT2, _points, None, "dim", "z2"),
    "z3_interleaved": (POINT3, _points, False, "zscan", "z3"),
    "z2_interleaved": (POINT2, _points, False, "zscan", "z2"),
    "xz3": (XZ3, _polygons, None, "xz", "xz3"),
    "xz2": (XZ2, _polygons, None, "xz", "xz2"),
}


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind(request):
    spec, make, dim, tag, z = KINDS[request.param]
    dated = "dtg" in spec
    cols, centers = make(1500 if make is _polygons else 3000, seed=len(request.param), with_dtg=dated)
    jdi, tdi = _pair(spec, cols, dim)
    assert tdi._z_kind == z and tdi._dim_mode == (tag == "dim")
    return request.param, jdi, tdi, _tiles(centers, dated), tag


@pytest.mark.parametrize("q", [1, 3, 8])
def test_fused_matches_the_jax_package_and_serial(kind, q):
    name, jdi, tdi, tiles, tag = kind
    qs = tiles[:q]
    lbs = [tdi._loose_bounds(parse_ecql(t)) for t in qs]
    assert all(lb is not None and lb[0] == tag for lb in lbs)
    if name == "z3_interleaved" and q > 1:  # a different bin count per query
        assert len({int((lb[2] >= 0).sum()) for lb in lbs}) > 1
    serial = [tdi.count(t, loose=True) for t in qs]
    assert sum(serial) > 0
    got = tdi.fused_loose_counts(qs, loose=True)
    assert got == serial == jdi.fused_loose_counts(qs, loose=True)
    tb, jb = tdi.fused_loose_query(qs, loose=True), jdi.fused_loose_query(qs, loose=True)
    for t, a, b in zip(qs, tb, jb):
        np.testing.assert_array_equal(a.fids, tdi.query(t, loose=True).fids)
        np.testing.assert_array_equal(np.sort(a.fids), np.sort(b.fids))


def test_mixed_r_buckets_in_one_group():
    """Real windows merge into one bt range (R = 1), so a group with R = 1
    and R = 2 is built by hand: a query's range split in two gives the same
    rows. Both packages pad to R = 2 with never-matching ranges."""
    cols, centers = _points(3000, seed=21)
    jdi, tdi = _pair(POINT3, cols)
    qs = _tiles(centers, True, k=5)
    lbs = [tdi._loose_bounds(parse_ecql(t)) for t in qs]
    split = []
    for i, (_, qa, r) in enumerate(lbs):
        assert r == 1
        if i % 2:
            lo, hi = int(qa[4]), int(qa[5])
            mid = (lo + hi) // 2
            qa = np.concatenate([qa[:4], np.array([lo, mid, mid + 1, hi], np.uint32)])
            r = 2
        split.append(("dim", qa, r))
    want = [tdi.count(t, loose=True) for t in qs]
    assert [int(v) for v in tdi._fused_dim(split, "count")] == want
    assert [int(v) for v in np.asarray(jdi._fused_dim(split, 8, "count"))[: len(qs)]] == want
    m = tdi._fused_dim(split, "mask")
    assert m.shape == (len(qs), len(tdi))
    for t, row in zip(qs, m):
        np.testing.assert_array_equal(row.numpy(), tdi.mask(t, loose=True))


# -- decline rules: None in both packages --------------------------------------


@pytest.fixture(scope="module")
def z3dim():
    cols, centers = _points(2000, seed=31)
    return _pair(POINT3, cols) + (_tiles(centers, True, k=4),)


def _both(jdi, tdi, fn):
    return fn(jdi), fn(tdi)


def test_decline_no_queries(z3dim):
    jdi, tdi, _ = z3dim
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts([], loose=True)) == (None, None)
    assert _both(jdi, tdi, lambda d: d.fused_loose_query([], loose=True)) == (None, None)


@pytest.mark.parametrize("loose", [False, None])
def test_decline_loose_off(z3dim, loose):
    jdi, tdi, qs = z3dim
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts(qs, loose=loose)) == (None, None)


def test_decline_a_query_the_key_planes_cannot_answer(z3dim):
    jdi, tdi, qs = z3dim
    for bad in ("name = 'a'", qs[0] + " AND name = 'a'", "INCLUDE"):
        assert _both(jdi, tdi, lambda d: d.fused_loose_counts([qs[1], bad], loose=True)) == (None, None)


def test_decline_labeled_rows():
    cols, centers = _points(500, seed=32)
    cols[VIS_COLUMN] = np.random.default_rng(0).choice(["", "A"], 500)
    jdi, tdi = _pair(POINT3, cols)
    qs = _tiles(centers, True, k=3)
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts(qs, loose=True)) == (None, None)


def test_decline_empty_index():
    cols, centers = _points(10, seed=33)
    empty = {k: v[:0] for k, v in cols.items()}
    jdi, tdi = _pair(POINT3, empty)
    qs = _tiles(centers, True, k=2)
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts(qs, loose=True)) == (None, None)


def test_decline_mixed_engines(z3dim, monkeypatch):
    """One index has one key layout, so a group mixes engines only through
    its loose bounds: a dim-plane query beside an interleaved one."""
    jdi, tdi, qs = z3dim
    cols, _ = _points(300, seed=34)
    ji, ti = _pair(POINT3, cols, dim_planes=False)
    for d, other in ((jdi, ji), (tdi, ti)):
        alien = other._loose_bounds(other._parse(qs[1]))
        real = d._loose_bounds
        monkeypatch.setattr(d, "_loose_bounds", lambda f, real=real, alien=alien, q1=repr(
            d._parse(qs[1])): alien if repr(f) == q1 else real(f))
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts(qs[:2], loose=True)) == (None, None)


def test_decline_a_z2_query_in_a_z3_group(z3dim):
    jdi, tdi, qs = z3dim
    lb = tdi._loose_bounds(parse_ecql(qs[0]))
    z2 = ("dim", lb[1][:4].copy(), 0)
    assert jdi._fused_dim([lb, z2], 2, "count") is None
    assert tdi._fused_dim([lb, z2], "count") is None


def test_decline_a_window_past_64_bins():
    cols, centers = _points(800, seed=35)
    cols["dtg"] = np.random.default_rng(2).integers(T0, T0 + 800 * DAY, 800)  # 115 week bins
    jdi, tdi = _pair(POINT3, cols, dim_planes=False)
    q = f"BBOX(geom, -10, -10, 10, 10) AND dtg DURING {_iso(T0)}/{_iso(T0 + 500 * DAY)}"
    assert tdi._loose_bounds(parse_ecql(q)) is None
    ok = _tiles(centers, True, k=1)[0]
    assert _both(jdi, tdi, lambda d: d.fused_loose_counts([ok, q], loose=True)) == (None, None)


def test_bin_before_1970_never_matches_padding():
    """Rows in week bin -1 (the last week of 1969). The port never matches
    an id < 0: its fused answers equal its serial ones, and a window over
    bin -1 declines (the exact scan answers it serially). The reference's
    XLA compare lets those rows match the padding of every padded query,
    so its fused counts differ from its own serial ones there (ROADMAP
    section 3)."""
    cols, _ = _points(2000, seed=36)
    rng = np.random.default_rng(1)
    cols["dtg"][:50] = rng.integers(-7 * DAY + 1, -1, 50)
    cols["geom"][:50] = rng.uniform(-5, 5, (50, 2)).astype(np.float32)
    jdi, tdi = _pair(POINT3, cols, dim_planes=False)
    assert tdi._bin_range[0] == -1
    box = "BBOX(geom, -10, -10, 10, 10)"
    qs = [f"{box} AND dtg DURING {_iso(T0 + 4 * DAY)}/{_iso(T0 + 5 * DAY)}",
          f"{box} AND dtg DURING {_iso(T0 + 4 * DAY)}/{_iso(T0 + 19 * DAY)}",
          f"{box} AND dtg DURING {_iso(T0 + 8 * DAY)}/{_iso(T0 + 9 * DAY)}"]
    serial = [tdi.count(q, loose=True) for q in qs]
    assert tdi.fused_loose_counts(qs, loose=True) == serial
    pre = set(range(50))
    for b in tdi.fused_loose_query(qs, loose=True):
        assert not pre & set(b.fids.tolist())
    jf = jdi.fused_loose_counts(qs, loose=True)
    assert jf[0] == serial[0] + 50 and jf[2] == serial[2] + 50  # the reference's fault
    over = f"{box} AND dtg DURING 1969-12-26T00:00:00Z/1970-01-02T00:00:00Z"
    assert tdi.fused_loose_counts([over], loose=True) is None
    assert tdi.count(over, loose=True) == tdi.count(over) == jdi.count(over)


def test_fused_launch_failpoint_raises(z3dim):
    _, tdi, qs = z3dim
    with failpoints.failpoint_override("fail.device.launch", "raise"):
        with pytest.raises(failpoints.FailpointError):
            tdi.fused_loose_counts(qs, loose=True)


# -- the batched plain versions against per-query loops -----------------------


@pytest.mark.parametrize("r", [0, 1, 2, 4, 8])
def test_batched_dim_plain_equals_per_query_loop(r):
    rng = np.random.default_rng(r)
    n, maxi = 4099, (1 << 21) - 1
    planes = [torch.from_numpy(rng.integers(0, maxi + 1, n).astype(np.uint32)) for _ in range(2)]
    if r:
        planes.append(torch.from_numpy(rng.integers(0, 8 << 21, n).astype(np.uint32)))
    q = np.empty((5, 4 + 2 * r), np.uint32)
    for i in range(5):
        q[i, :4] = np.concatenate([np.sort(rng.integers(0, maxi, 2)), np.sort(rng.integers(0, maxi, 2))])
        for k in range(r):
            q[i, 4 + 2 * k: 6 + 2 * k] = np.sort(rng.integers(0, 8 << 21, 2))
    q[-1] = [1, 0, 1, 0] + [0xFFFFFFFF, 0] * r
    m = zscan.batched_dim_mask_rt(r)(*planes, q)
    assert m.shape == (5, n) and not m[-1].any()
    for i in range(5):
        assert torch.equal(m[i], zscan.dimscan_plain(q[i], *planes))
        assert int(zscan.dimscan_count(q[i], *planes)) == int(m[i].sum())
    assert torch.equal(zscan.batched_dimscan_count(q, *planes), m.sum(dim=1, dtype=torch.int32))
    assert torch.equal(zscan.batched_dimscan_mask(q, *planes), m)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_batched_plain_masks_equal_per_query_loops(kind):
    """The group the fused paths stack, through the batched plain versions,
    row by row equal to each query's own loose scan."""
    name, _, tdi, tiles, tag = kind
    lbs = [tdi._loose_bounds(parse_ecql(t)) for t in tiles]
    z, cols = tdi._z_kind, tdi._cols
    if tag == "dim":
        r = max(lb[2] for lb in lbs)
        qmat = np.stack([lb[1] for lb in lbs])
        planes = [cols[p] for p in ("__znx", "__zny", "__zbt")[: 3 if r else 2]]
        m = zscan.batched_dim_mask_rt(r)(*planes, qmat)
        for i, lb in enumerate(lbs):
            assert torch.equal(m[i], zscan.dimscan_mask(lb[1], *planes))
        return
    hi, lo, bins = cols["__zhi"], cols["__zlo"], cols.get("__zbin")
    _, mask_fn, ops = tdi._loose_args(lbs[0])
    single = [tdi._loose_args(lb)[1](*ops) for lb in lbs]
    if z in ("z3", "xz3"):
        bmax = max(len(lb[2]) for lb in lbs)
        shape = (len(lbs), bmax) + lbs[0][1].shape[1:]
        if z == "xz3":
            rmax = max(lb[1].shape[1] for lb in lbs)
            shape = (len(lbs), bmax, rmax, 4)
        bounds, ids = np.zeros(shape, np.uint32), np.full((len(lbs), bmax), -1, np.int32)
        for i, lb in enumerate(lbs):
            b = zscan.pad_ranges(lb[1], min_r=shape[2]) if z == "xz3" else lb[1]
            bounds[i, : len(lb[2])], ids[i, : len(lb[2])] = b, lb[2]
        m = zscan.batched_kind_mask(z)(hi, lo, bins, bounds, ids)
    else:
        rmax = max(lb[1].shape[0] for lb in lbs)
        bounds = np.stack([zscan.pad_ranges(lb[1], min_r=rmax) if z == "xz2" else lb[1]
                           for lb in lbs])
        m = zscan.batched_kind_mask(z)(hi, lo, bounds)
    for i in range(len(lbs)):
        assert torch.equal(m[i], single[i])
    if z in ("z3", "z2"):  # the kernel's routing: the same plain answer on CPU planes
        args = (bounds, ids if z == "z3" else None, hi, lo)
        assert torch.equal(zscan.batched_zscan_mask(*args, bins=bins), m)
        assert torch.equal(zscan.batched_zscan_count(*args, bins=bins),
                           m.sum(dim=1, dtype=torch.int32))


def test_batched_zscan_table_layout():
    """The packed table the batched kernel reads: only real entries (ids
    >= 0, none empty in a dimension) as records of their query, cell boxes
    compact (each dimension's de-interleaved lo and hi; some bin holds two
    queries' records) and random words
    masked; a padded query starts no launch; a binned launch's index finds
    each bin's records; and the records, read back from the table, give
    the semantic mask query by query."""
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.curves.zorder import decode_3d_np, u64_hi_lo

    rng = np.random.default_rng(5)
    n = 3001
    h, l = (torch.from_numpy(a) for a in u64_hi_lo(Z3SFC().index(
        rng.uniform(-180, 180, n), rng.uniform(-90, 90, n), rng.uniform(0, 604_800, n))))
    bins = torch.from_numpy((2600 + rng.integers(0, 12, n)).astype(np.int32))
    maxi = (1 << 21) - 1
    bounds = np.zeros((5, 4, 3, 6), np.uint32)
    ids = np.full((5, 4), -1, np.int32)
    boxes = {}
    for q, b in enumerate((1, 2, 4, 3, 0)):
        for e in range(b):
            lo, hi = np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0)
            bounds[q, e] = zscan.z3_dim_bounds(tuple(lo), tuple(hi))
            boxes[(q, e)] = (lo, hi)
        ids[q, :b] = 2600 + rng.permutation(12)[:b]
    ids[3] = ids[2, [1, 0, 2, 3]]  # bins that hold two queries' records: cell boxes pack compact
    ids[3, 3] = -1
    bounds[2, 3] = rng.integers(0, 1 << 32, (3, 6), dtype=np.uint64).astype(np.uint32)
    bounds[2, 3, :, 2:4], bounds[2, 3, :, 4:6] = 0, 0xFFFFFFFF  # random masks, lo <= hi
    bounds[1, 1, 0, 2:4] = bounds[1, 1, 0, 4:6] + np.array([0, 1], np.uint32)  # lo > hi: empty
    pk = zscan.batched_zscan(bounds, ids)
    assert [(lc.q0, lc.q1, lc.nc, lc.nm, lc.binned) for lc in pk.launches] == [(0, 4, 8, 1, True)]
    assert list(pk.idle) == [4]  # the padded query: no launch
    c, m, index = pk._records(pk.launches[0])
    first = pk.launches[0].first
    assert first == int(ids[ids >= 0].min())
    for rec in c:  # (lo_d, hi_d) per dimension, bin, query
        q = int(rec[7])
        e = int(np.nonzero(ids[q] == rec[6])[0][0])
        lo, hi = boxes[(q, e)]
        assert list(rec[:6]) == [v for d in range(3) for v in (lo[d], hi[d])]
        assert (q, e) != (1, 1)
    assert list(m[0, :2]) == [ids[2, 3], 2] and np.array_equal(m[0, 4:22], bounds[2, 3].reshape(-1))
    for i in range(len(index) - 1):  # each bin's records, compact then masked
        assert all(r[6] == first + i for r in c[index[i, 0]: index[i + 1, 0]])
        assert all(r[0] == first + i for r in m[index[i, 1]: index[i + 1, 1]])
    assert index[-1].tolist() == [len(c), len(m)]
    coords = decode_3d_np(np.asarray(zscan._u64(h.numpy(), l.numpy())))
    assert np.array_equal(np.stack(coords), np.stack([v.numpy() for v in
                                                       zscan.zorder.decode_3d_hi_lo_t(h, l)]))
    got = pk.plain(bins, h, l)
    for q in range(5):
        assert torch.equal(got[q], zscan.z3_zscan_mask(h, l, bins, bounds[q], ids[q]))
    assert torch.equal(got, zscan.batched_kind_mask("z3")(h, l, bins, bounds, ids))


def test_batched_launch_limits():
    q = np.zeros((65, 4), np.uint32)
    planes = [torch.zeros(8, dtype=torch.uint32)] * 2
    with pytest.raises(ValueError, match="1 to 64"):
        zscan.batched_dimscan_count(q, *planes)
    with pytest.raises(ValueError, match="1 to 64"):
        zscan.batched_zscan_count(np.zeros((0, 2, 6), np.uint32), None, *planes)
    with pytest.raises(TypeError):
        zscan.batched_dimscan_count(q[:2].astype(np.int64), *planes)


# -- launch accounting -----------------------------------------------------------


def test_count_launch_is_exact_under_threads():
    """8 threads counting at once lose no launch (a stub kernel wrapper
    that only counts, as every real wrapper does after its launch)."""
    def stub():
        for _ in range(5000):
            kernels.count_launch("dimscan_batched_z3_count")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_counts()
        threads = [threading.Thread(target=stub) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["dimscan_batched_z3_count"] == 8 * 5000
    finally:
        sys.setswitchinterval(old)
        kernels.reset_counts()


def test_every_entry_point_has_a_signature():
    """Each C entry point of csrc/ is bound once at load, from SIGNATURES,
    with one argtype per parameter (ctypes passes surplus arguments
    unconverted, which cuts pointers)."""
    from geomesa_tpu_torch.kernels import _build

    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        entry = dict(re.findall(r'extern "C" int (gm_\w+)\(([^)]*)\)', src))
        assert set(entry) == set(_build.SIGNATURES[name]), name
        for fn, params in entry.items():
            assert len(params.split(",")) == len(_build.SIGNATURES[name][fn][0]), fn
    assert all(k in kernels.LAUNCHES for k in (
        "dimscan_batched_z3_count", "dimscan_batched_z2_mask", "zscan_batched_z3_mask",
        "zscan_batched_z2_count"))


# -- the scheduler (ported from tests/test_sched.py) ----------------------------


@pytest.fixture(scope="module")
def resident_di():
    cols, centers = _points(3000, seed=5)
    tdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", POINT3),
                                                           cols)),
                      "t", z_planes=True, device="cpu")
    return tdi, _tiles(centers, True, k=8)


def _gate_scheduler(**cfg):
    """Scheduler with one worker parked on a gate, so later submissions
    pile into the queue deterministically."""
    sched = QueryScheduler(SchedConfig(max_inflight=1, default_deadline_ms=None, **cfg))
    gate = threading.Event()
    started = threading.Event()
    sched.submit(fn=lambda: (started.set(), gate.wait(10)) and None)
    assert started.wait(5), "worker never claimed the blocker"
    return sched, gate


def test_fused_device_results_match_serial(resident_di):
    di, qs = resident_di
    serial = [di.count(q, loose=True) for q in qs]
    assert sum(serial) > 0
    assert di.fused_loose_counts(qs, loose=True) == serial
    for q, got in zip(qs, di.fused_loose_query(qs, loose=True)):
        np.testing.assert_array_equal(got.fids, di.query(q, loose=True).fids)


def test_fused_declines_unanswerable_groups(resident_di):
    di, qs = resident_di
    assert di.fused_loose_counts([qs[0], "name = 'a'"], loose=True) is None
    assert di.fused_loose_counts(qs[:2], loose=False) is None


def test_scheduler_fuses_concurrent_queries(resident_di):
    """K compatible queued queries run in fewer launches than K, with
    per-query results equal to serial; each rider's trace shows the shared
    launch and its cost ledger the fair share."""
    di, qs = resident_di
    serial = [di.count(q, loose=True) for q in qs]
    sched, gate = _gate_scheduler(fusion_window_ms=25.0)
    try:
        reqs, traces, costs = [], [], []
        for q in qs:
            with tracing.TRACER.trace("count") as t, ledger.collect_cost() as c:
                reqs.append(sched.submit(fuse=FusableQuery(di, q, "count", loose=True)))
            traces.append(t)
            costs.append(c)
        gate.set()
        assert [sched.wait(r) for r in reqs] == serial
        assert sched.fused_queries >= len(qs)
        assert sched.launches < 1 + len(qs)  # the blocker + the fused group(s)
        snap = sched.snapshot()
        assert snap["fusion_factor"] is not None and snap["fusion_factor"] > 1.0
        assert snap["fusion_fallbacks"] == 0
        ex = [[s for s in t.root.children if s.name == "sched.execute"] for t in traces]
        assert all(len(e) == 1 and e[0].attrs["fused"] > 1 for e in ex)
        assert len({e[0].attrs["launch"] for e in ex}) == sched.launches - 1
        assert all(c.snapshot_fields()["fusion_width"] > 1 for c in costs)
    finally:
        gate.set()
        sched.shutdown()


def test_two_workers_overlapping_groups_match_serial(resident_di):
    """Two workers answer overlapping fused groups of counts and features
    at once; each result belongs to its own request."""
    di, qs = resident_di
    want_c = [di.count(q, loose=True) for q in qs]
    want_f = [di.query(q, loose=True).fids for q in qs]
    sched = QueryScheduler(SchedConfig(max_inflight=2, max_queue=512, fusion_window_ms=1.0,
                                       default_deadline_ms=None))
    try:
        reqs = [(i, op, sched.submit(fuse=FusableQuery(di, qs[i], op, loose=True)))
                for _ in range(6) for i in range(len(qs)) for op in ("count", "query")]
        for i, op, r in reqs:
            got = sched.wait(r)
            if op == "count":
                assert got == want_c[i]
            else:
                np.testing.assert_array_equal(got.fids, want_f[i])
        assert sched.fused_queries > 0 and sched.launches < len(reqs)
    finally:
        sched.shutdown()


def test_fusion_failure_falls_back_to_serial(resident_di):
    """A fused launch that fails (the fail.device.launch chaos point) costs
    the group its fusion, never its answers. The point fires once, at the
    fused launch: the serial counts it falls back to hit the same point,
    as the reference's do, and must run."""
    di, qs = resident_di
    serial = [di.count(q, loose=True) for q in qs]
    sched, gate = _gate_scheduler(fusion_window_ms=25.0)
    try:
        with failpoints.failpoint_override("fail.device.launch", "raise:1"):
            reqs, traces = [], []
            for q in qs:
                with tracing.TRACER.trace("count") as t:
                    reqs.append(sched.submit(fuse=FusableQuery(di, q, "count", loose=True)))
                traces.append(t)
            gate.set()
            assert [sched.wait(r) for r in reqs] == serial
        assert sched.fused_queries == 0 and sched.launches == 1 + len(qs)
        # the fallback is counted, and each rider's serial span says why
        assert sched.fusion_fallbacks >= 1
        assert sched.snapshot()["fusion_fallbacks"] == sched.fusion_fallbacks
        ex = [[s for s in t.root.children if s.name == "sched.execute"] for t in traces]
        assert all(len(e) == 1 and e[0].attrs["fused"] == 1 for e in ex)
        assert sum(e[0].attrs.get("fallback") == "raised" for e in ex) >= 2
    finally:
        gate.set()
        sched.shutdown()


def test_declined_group_counts_a_fallback(resident_di):
    """A group the index declines to fuse (one query has no loose bounds)
    runs serially, exact, and is counted as a fallback."""
    di, qs = resident_di
    group = [qs[0], "name = 'a'", qs[1]]
    serial = [di.count(q, loose=True) for q in group]
    sched, gate = _gate_scheduler(fusion_window_ms=25.0)
    try:
        reqs, traces = [], []
        for q in group:
            with tracing.TRACER.trace("count") as t:
                reqs.append(sched.submit(fuse=FusableQuery(di, q, "count", loose=True)))
            traces.append(t)
        gate.set()
        assert [sched.wait(r) for r in reqs] == serial
        assert sched.fused_queries == 0 and sched.fusion_fallbacks == 1
        assert [[s.attrs.get("fallback") for s in t.root.children if s.name == "sched.execute"]
                for t in traces] == [["declined"]] * len(group)
    finally:
        gate.set()
        sched.shutdown()


def test_backpressure_rejects_and_never_deadlocks():
    sched, gate = _gate_scheduler(max_queue=2, fusion_window_ms=0)
    try:
        r1 = sched.submit(fn=lambda: 1)
        r2 = sched.submit(fn=lambda: 2)
        with pytest.raises(RejectedError) as ei:
            sched.submit(fn=lambda: 3)
        assert ei.value.retry_after_s > 0
        gate.set()
        assert sched.wait(r1) == 1
        assert sched.wait(r2) == 2
        assert sched.rejected == 1
        assert sched.run(fn=lambda: 4) == 4  # queue drained: admission opens again
    finally:
        gate.set()
        sched.shutdown()


def test_deadline_expires_in_queue():
    sched, gate = _gate_scheduler(fusion_window_ms=0)
    try:
        req = sched.submit(fn=lambda: 1, deadline_ms=30.0)
        with pytest.raises(DeadlineExpired):
            sched.wait(req)
        assert sched.expired >= 1
        gate.set()
        assert sched.run(fn=lambda: 2) == 2  # never executed, the queue moves on
    finally:
        gate.set()
        sched.shutdown()


def test_priority_and_tenant_fairness():
    sched, gate = _gate_scheduler(fusion_window_ms=0)
    try:
        order: list = []
        rs = [sched.submit(fn=lambda: order.append("batch"), lane=LANE_BATCH)]
        for i in range(3):  # noisy tenant A before quiet tenant B
            rs.append(sched.submit(fn=lambda i=i: order.append(f"A{i}"), tenant="A"))
        rs.append(sched.submit(fn=lambda: order.append("B0"), tenant="B"))
        gate.set()
        for r in rs:
            sched.wait(r)
        assert order[-1] == "batch"  # the interactive lane drains first
        assert order.index("B0") < order.index("A2")  # round-robin over tenants
    finally:
        gate.set()
        sched.shutdown()


def test_config_from_props(monkeypatch):
    monkeypatch.setenv("GEOMESA_TPU_SCHED_MAX_QUEUE", "7")
    with prop_override("sched.max.fusion", 48), prop_override("sched.default.deadline.ms", 0):
        cfg = SchedConfig.from_props()
    assert (cfg.max_queue, cfg.max_fusion, cfg.default_deadline_ms) == (7, 64, None)
    assert cfg.max_inflight == 2 and cfg.fusion_window_ms == 2.0


# -- the scheduler's failure domains (ported from tests/test_resilience.py) ----


@pytest.fixture()
def fresh_breakers():
    resilience.reset()
    yield
    resilience.reset()


def test_watchdog_fails_stuck_launch_and_replaces_worker(fresh_breakers):
    unwedge = threading.Event()
    sched = QueryScheduler(SchedConfig(max_queue=8, max_inflight=1, default_deadline_ms=None))
    try:
        with prop_override("resilience.launch.timeout.s", 0.3):
            t0 = time.monotonic()
            timeouts0 = metrics.resilience_watchdog_timeouts.value()
            req = sched.submit(fn=lambda: unwedge.wait(10), device=True)
            with pytest.raises(resilience.LaunchStuckError):
                sched.wait(req)
            assert time.monotonic() - t0 < 5.0  # promptly, not after the wedge
            assert sched.run(fn=lambda: 42) == 42  # the wedged worker was replaced
            snap = sched.snapshot()
            assert snap["watchdog_timeouts"] == 1 and snap["running"] == 0
            with sched._cv:
                assert not sched._inflight  # the abandoned entry was popped
            assert resilience.device_breaker().snapshot()["consecutive_failures"] >= 1
            assert metrics.resilience_watchdog_timeouts.value() == timeouts0 + 1
    finally:
        unwedge.set()
        sched.close(timeout=2.0)


def test_watchdog_exactly_once_when_stuck_fn_returns(fresh_breakers):
    release = threading.Event()
    sched = QueryScheduler(SchedConfig(max_queue=8, max_inflight=1, default_deadline_ms=None))
    try:
        with prop_override("resilience.launch.timeout.s", 0.2):
            req = sched.submit(fn=lambda: release.wait(10) or "late", device=True)
            with pytest.raises(resilience.LaunchStuckError):
                sched.wait(req)
            release.set()  # the wedged fn now completes
            time.sleep(0.3)
            assert isinstance(req.error, resilience.LaunchStuckError)  # the first stands
            assert req.result is None
            assert sched.run(fn=lambda: 7) == 7
    finally:
        release.set()
        sched.close(timeout=2.0)


def test_watchdog_exempts_host_groups(fresh_breakers):
    sched = QueryScheduler(SchedConfig(max_queue=8, max_inflight=1, default_deadline_ms=None))
    try:
        with prop_override("resilience.launch.timeout.s", 0.2):
            c0 = resilience.device_breaker().snapshot()["consecutive_failures"]
            assert sched.run(fn=lambda: time.sleep(0.6) or "done") == "done"
            assert sched.snapshot()["watchdog_timeouts"] == 0
            assert resilience.device_breaker().snapshot()["consecutive_failures"] == c0
    finally:
        sched.close(timeout=2.0)


def test_watchdog_stall_clock_restarts_on_rider_progress(fresh_breakers):
    sched = QueryScheduler(SchedConfig(max_queue=16, max_inflight=1, fusion_window_ms=200,
                                       max_fusion=8, default_deadline_ms=None))

    class _Serial:
        """Fusable by key, but execute_group declines (no DeviceIndex), so
        the group runs serially through run_serial."""

        fusable = True
        key = ("k",)

        def run_serial(self):
            time.sleep(0.15)
            return "ok"

    try:
        with prop_override("resilience.launch.timeout.s", 0.3):
            reqs = [sched.submit(fuse=_Serial()) for _ in range(4)]
            assert [sched.wait(r) for r in reqs] == ["ok"] * 4
            assert sched.snapshot()["watchdog_timeouts"] == 0
    finally:
        sched.close(timeout=2.0)


def test_sched_worker_crash_fails_typed_and_keeps_serving():
    sched = QueryScheduler(SchedConfig(max_queue=8, max_inflight=1, default_deadline_ms=None))
    try:
        with failpoints.failpoint_override("fail.sched.worker", "raise:1"):
            with pytest.raises(failpoints.FailpointError):
                sched.run(fn=lambda: 1)
            assert sched.run(fn=lambda: 2) == 2  # the same worker, alive
        assert sched.snapshot()["worker_failures"] == 1
    finally:
        sched.close(timeout=2.0)


def test_exactly_once_under_worker_chaos():
    sched = QueryScheduler(SchedConfig(max_queue=64, max_inflight=2, default_deadline_ms=None))
    try:
        with failpoints.failpoint_override("fail.sched.worker", "raise:5"):
            reqs = [sched.submit(fn=lambda i=i: i) for i in range(20)]
            ok = failed = 0
            for i, r in enumerate(reqs):
                try:
                    assert sched.wait(r) == i
                    ok += 1
                except failpoints.FailpointError:
                    failed += 1
            assert ok + failed == 20 and failed >= 1 and ok >= 1
    finally:
        sched.close(timeout=2.0)


def test_retry_after_computed_and_jittered():
    block = threading.Event()
    sched = QueryScheduler(SchedConfig(max_queue=1, max_inflight=1, default_deadline_ms=None,
                                       retry_after_s=2.0))
    try:
        for _ in range(3):  # completions seed the service-time EWMA
            sched.run(fn=lambda: time.sleep(0.01))
        held = sched.submit(fn=lambda: block.wait(5))
        time.sleep(0.05)  # claimed; the single queue slot is free
        queued = sched.submit(fn=lambda: None)
        values = []
        for _ in range(8):
            with pytest.raises(RejectedError) as ei:
                sched.submit(fn=lambda: None)
            values.append(ei.value.retry_after_s)
        assert all(0.05 <= v <= 30.0 for v in values)
        assert len({round(v, 6) for v in values}) > 1  # a fleet must not all come back at once
        assert sched.snapshot()["retry_after_estimate_s"] > 0
        block.set()
        sched.wait(held)
        sched.wait(queued)
    finally:
        block.set()
        sched.close(timeout=2.0)


def test_breaker_opens_half_opens_and_closes(fresh_breakers):
    with prop_override("resilience.breaker.failures", 2), \
            prop_override("resilience.breaker.cooldown.s", 0.05):
        br = resilience.CircuitBreaker("probe", "device")
        br.record_failure()
        assert br.state == "closed"
        br.record_failure()
        assert br.state == "open" and not br.allow()
        time.sleep(0.06)
        assert br.allow() and br.state == "half-open"
        assert not br.allow()  # one probe at a time
        br.release_probe()
        assert br.allow()
        br.record_success()
        assert br.state == "closed"



def test_request_contexts_ride_to_the_worker():
    """The submitter's trace, cost collector and degradation collector
    reach the work a worker runs for it (the scheduler attaches them per
    request); ``spawn_thread`` carries them to a thread it starts."""
    from geomesa_tpu_torch.spawn import spawn_thread

    sched = QueryScheduler(SchedConfig(max_inflight=1, default_deadline_ms=None))
    try:
        seen = {}

        def work():
            resilience.note_degraded("device-breaker-open")
            seen["span"] = tracing.capture()
            return 1

        with tracing.TRACER.trace("req") as t, \
                ledger.collect_cost() as cost, resilience.collect_degraded() as reasons:
            assert sched.run(fn=work, device=True) == 1
            th = spawn_thread(lambda: seen.setdefault("thread", (tracing.capture(),
                                                                 ledger.capture_cost())),
                              name="carry")
            th.start()
            th.join(timeout=5)
        assert reasons == ["device-breaker-open"]
        assert seen["span"].name == "sched.execute" and seen["span"].trace is t
        assert cost.snapshot_fields()["device_launches"] == 1
        assert seen["thread"] == (t.root, cost)
        assert [s.name for s in t.root.children] == ["sched.wait", "sched.execute"]
    finally:
        sched.shutdown()


def test_scheduler_metrics_move():
    before = (metrics.sched_queries.value(), metrics.sched_launches.value(),
              metrics.sched_wait_seconds.stats()["n"])
    sched = QueryScheduler(SchedConfig(max_inflight=2, default_deadline_ms=None))
    try:
        assert [sched.run(fn=lambda i=i: i) for i in range(5)] == list(range(5))
    finally:
        sched.shutdown()
    assert metrics.sched_queries.value() == before[0] + 5
    assert metrics.sched_launches.value() == before[1] + 5
    assert metrics.sched_wait_seconds.stats()["n"] == before[2] + 5
    assert metrics.sched_queue_depth.value() == 0


def test_ladder():
    from geomesa_tpu_torch.bucketing import bucket_cap, ladder

    assert ladder(64) == [1, 2, 4, 8, 16, 32, 64]
    assert ladder(48) == [1, 2, 4, 8, 16, 32, 64] and ladder(48)[-1] == bucket_cap(48)
    assert ladder(1) == [1] and ladder(0) == [1] and ladder(5, floor=3) == [3, 6]
