"""Port parity for the xz kinds: non-point (XZ2/XZ3) schemas in
``geomesa_tpu_torch`` against ``geomesa_tpu``, on the same rows.

Checked, bit-exact: the XZ curves' ``index`` and ``ranges`` (random and
adversarial boxes: point boxes, boxes on cell boundaries, the whole world,
lon = 180 and lat = 90), the port's torch encode against the counterpart's
``index``, the loose query bounds, the range masks (except the
negative-bin padding case, where the port's rule is asserted), and the
resident ``DeviceIndex`` on xz2 and xz3 schemas -- loose and exact
``count``/``mask``/``query`` (bbox, during, dwithin, the envelope
prefilter with its host residual, the DE-9IM relations, NOT/OR),
``stats`` Count, per-auth answers, ``from_planes`` fed the counterpart's
planes, ``density`` returning ``None``. Coordinates sit on a 2^-10 grid,
so they are exact in float32 and the counterpart's float64 planes on the
CPU decide every compare as the port's float32 planes do; the float32
envelope probe at the end covers the one place where they need not.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.curves.xz2 import XZ2SFC as JXZ2
from geomesa_tpu.curves.xz3 import XZ3SFC as JXZ3
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.ops import zscan as jz
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.convert import planes_from_numpy
from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.curves.xz3 import XZ3SFC
from geomesa_tpu_torch.device_cache import Z_BIN, Z_HI, Z_LO, DeviceIndex, _z_planes_np
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.ops import zscan as tz
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
XZ3_SPEC = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"
XZ2_SPEC = "name:String,count:Int,*geom:Polygon:srid=4326"
GRID = 1024.0  # coordinates on a 2^-10 grid: exact in float32


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _snap(v):
    return np.round(np.asarray(v, np.float64) * GRID) / GRID


def _fmt(v) -> str:
    return repr(float(v))


def _ring(pts) -> str:
    pts = list(pts) + [pts[0]]
    return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in pts) + ")"


def _rect(x, y, w, h):
    pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
    return [(float(_snap(a)), float(_snap(b))) for a, b in pts]


def _wkt_rows(n, seed):
    """n WKT geometries: rectangles, 4-to-8-vertex polygons, polygons with
    a hole, LineStrings and MultiPolygons, every coordinate on the grid;
    the first rows are adversarial (the whole world, the lon = 180 /
    lat = 90 corner, a point-sized polygon, squares that share edges and a
    corner with the relation query square, a box on the query's edges)."""
    rng = np.random.default_rng(seed)
    rows = [
        "POLYGON (" + _ring(_rect(-180.0, -90.0, 360.0, 180.0)) + ")",
        "POLYGON (" + _ring(_rect(179.5, 89.5, 0.5, 0.5)) + ")",
        "POLYGON (" + _ring([(2.5, 48.5), (2.5, 48.5), (2.5, 48.5)]) + ")",
        "POLYGON (" + _ring(_rect(10.0, 40.0, 2.0, 2.0)) + ")",  # shares x = 10
        "POLYGON (" + _ring(_rect(6.0, 36.0, 2.0, 2.0)) + ")",  # corner (8, 38)
        "POLYGON (" + _ring(_rect(7.0, 39.0, 2.0, 2.0)) + ")",  # overlaps
        "POLYGON (" + _ring(_rect(-10.0, 35.0, 40.0, 25.0)) + ")",  # on bbox edges
        "LINESTRING (8.0 40.0, 10.0 40.0)",  # along the query square's edge
        "LINESTRING (7.0 39.0, 11.0 39.0)",  # crosses the query square
    ]
    kinds = rng.choice(5, n, p=[0.5, 0.2, 0.1, 0.1, 0.1])
    for i in range(len(rows), n):
        x = float(_snap(rng.uniform(-170, 165)))
        y = float(_snap(rng.uniform(-85, 80)))
        w = float(_snap(rng.uniform(0.01, 5.0)))
        h = float(_snap(rng.uniform(0.01, 5.0)))
        k = kinds[i]
        if k == 0:
            rows.append("POLYGON (" + _ring(_rect(x, y, w, h)) + ")")
        elif k == 1:
            m = int(rng.integers(4, 9))
            a = np.sort(rng.uniform(0, 2 * np.pi, m))
            pts = list(zip(_snap(x + w * (1 + np.cos(a)) / 2), _snap(y + h * (1 + np.sin(a)) / 2)))
            rows.append("POLYGON (" + _ring(pts) + ")")
        elif k == 2:
            hole = _rect(x + w / 4, y + h / 4, w / 2, h / 2)
            rows.append("POLYGON (" + _ring(_rect(x, y, w, h)) + ", " + _ring(hole) + ")")
        elif k == 3:
            rows.append(f"LINESTRING ({_fmt(x)} {_fmt(y)}, {_fmt(x + w)} {_fmt(y + h)}, "
                        f"{_fmt(x + w)} {_fmt(y)})")
        else:
            rows.append(
                "MULTIPOLYGON ((" + _ring(_rect(x, y, w / 3, h / 3)) + "), ("
                + _ring(_rect(x + w / 2, y + h / 2, w / 3, h / 3)) + "))"
            )
    return np.array(rows, dtype=object)


def _columns(n, seed, with_dtg=True, labels=None):
    rng = np.random.default_rng(seed + 1)
    cols = {
        "name": np.array(["a", "b", "c"] * (n // 3) + ["a"] * (n % 3), dtype=object),
        "count": rng.integers(0, 1000, n),
        "geom": _wkt_rows(n, seed),
    }
    if with_dtg:
        cols["dtg"] = rng.integers(T0, T0 + 60 * DAY, n)
        cols["dtg"][:2] = [T0 + 9 * DAY, T0 + 14 * DAY]  # on window edges
    if labels is not None:
        cols[VIS_COLUMN] = rng.choice(labels, n)
    return cols


def _pair(spec, cols):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    jsft, sft = JSFT.create("p", spec), SimpleFeatureType.create("p", spec)
    jstore = JStore(JBatch.from_columns(jsft, dict(cols)))
    store = BatchStore(FeatureBatch.from_columns(sft, dict(cols)))
    jdi = JIndex(jstore, "p", z_planes=True)
    tdi = DeviceIndex(store, "p", z_planes=True, device="cpu")
    return jdi, tdi, sft, store


@pytest.fixture(scope="module")
def xz3():
    return _pair(XZ3_SPEC, _columns(1500, seed=11))


@pytest.fixture(scope="module")
def xz2():
    return _pair(XZ2_SPEC, _columns(1500, seed=12, with_dtg=False))


SQUARE = "POLYGON((8 38, 10 38, 10 40, 8 40, 8 38))"
DISTRICT = "POLYGON((-5 42, 3 40, 8 44.5, 6 51, -2 50, -5 42))"
SPATIAL = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -180, -90, 180, 90)",
    "BBOX(geom, 2.25, 48.5, 2.75, 49)",
    "BBOX(geom, 179.5, 89.5, 180, 90)",
    "BBOX(geom, 10, 10, 5, 5)",
    "DWITHIN(geom, POINT(5 45), 300, kilometers)",
    f"DWITHIN(geom, {DISTRICT}, 50, kilometers)",
    f"INTERSECTS(geom, {DISTRICT})",
    f"WITHIN(geom, {DISTRICT})",
    f"BBOX(geom, 0, 30, 20, 50) AND TOUCHES(geom, {SQUARE})",
    f"BBOX(geom, 0, 30, 20, 50) AND CROSSES(geom, {SQUARE})",
    f"BBOX(geom, 0, 30, 20, 50) AND OVERLAPS(geom, {SQUARE})",
    f"BBOX(geom, 0, 30, 20, 50) AND RELATE(geom, {SQUARE}, 'T*T***T**')",
    "NOT (BBOX(geom, -10, 35, 30, 60) OR count < 200) OR count > 900",
    "BBOX(geom, -10, 35, 30, 60) AND name LIKE 'a%'",
    "INCLUDE",
]
WINDOWS = [
    "dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "dtg DURING 2020-01-01T00:00:00Z/2020-01-02T00:00:00Z",
    "dtg DURING 2020-01-05T00:00:00Z/2020-02-20T00:00:00Z",
    "dtg DURING 2021-01-01T00:00:00Z/2021-02-01T00:00:00Z",
]
XZ3_QUERIES = (
    [f"{s} AND {w}" for s in SPATIAL[:5] for w in WINDOWS[:3]]
    + [WINDOWS[0], f"{SPATIAL[0]} AND {WINDOWS[3]}",
       f"{SPATIAL[7]} AND {WINDOWS[2]}", f"{SPATIAL[9]} AND {WINDOWS[2]}"]
    + SPATIAL
)


def _assert_same(jdi, tdi, ecql, auths=None):
    for loose in (False, True):
        assert tdi.count(ecql, loose=loose, auths=auths) == jdi.count(ecql, loose=loose, auths=auths)
        np.testing.assert_array_equal(
            tdi.mask(ecql, loose=loose, auths=auths), jdi.mask(ecql, loose=loose, auths=auths)
        )
        np.testing.assert_array_equal(
            np.sort(tdi.query(ecql, loose=loose, auths=auths).fids),
            np.sort(jdi.query(ecql, loose=loose, auths=auths).fids),
        )


# -- the curves --------------------------------------------------------------


def _boxes(seed, n=4000):
    """Random boxes plus the adversarial ones of tests/test_xz.py."""
    rng = np.random.default_rng(seed)
    xmin = rng.uniform(-180, 179, n)
    ymin = rng.uniform(-90, 89, n)
    w = rng.uniform(0, 3.0, n) * (10.0 ** rng.integers(-5, 2, n))
    xmax = np.minimum(xmin + w, 180.0)
    ymax = np.minimum(ymin + rng.uniform(0, 1, n) * w, 90.0)
    adv = np.array([
        [-180.0, -90.0, 180.0, 90.0],  # the whole world
        [0.0, 0.0, 0.0, 0.0],  # a point box
        [2.0, 48.0, 2.0, 48.0],
        [-180.0, -90.0, -180.0 + 360.0 * 0.25, -90.0 + 180.0 * 0.25],  # cell boundaries
        [10.0, 10.0, 10.0 + 360 * 2**-10, 10.0 + 180 * 2**-10],
        [-45.0, -45.0, -45.0 + 360 * 2**-12, -45.0 + 180 * 2**-12],
        [179.9, 89.9, 180.0, 90.0],  # lon = 180, lat = 90
        [180.0, 90.0, 180.0, 90.0],
        [-180.0, -90.0, -180.0, -90.0],
        [0.0, 0.0, 180.0, 90.0],
    ])
    return (np.concatenate([adv[:, 0], xmin]), np.concatenate([adv[:, 1], ymin]),
            np.concatenate([adv[:, 2], xmax]), np.concatenate([adv[:, 3], ymax]))


@pytest.mark.parametrize("g", [12, 7])
def test_xz2_index_and_card_encode_match(g):
    x0, y0, x1, y1 = _boxes(g)
    want = JXZ2(g).index(x0, y0, x1, y1)
    np.testing.assert_array_equal(XZ2SFC(g).index(x0, y0, x1, y1), want)
    hi, lo = XZ2SFC(g).index_hi_lo(*(torch.from_numpy(a) for a in (x0, y0, x1, y1)))
    assert hi.dtype == torch.uint32 and lo.dtype == torch.uint32
    np.testing.assert_array_equal(_u64(hi.numpy(), lo.numpy()), want.astype(np.uint64))


@pytest.mark.parametrize("g", [12, 5])
def test_xz3_index_and_card_encode_match(g):
    x0, y0, x1, y1 = _boxes(100 + g)
    rng = np.random.default_rng(g)
    sfc = XZ3SFC(TimePeriod.WEEK, g)
    t0 = rng.uniform(0, sfc.t_max, len(x0))
    t0[:3] = [0.0, sfc.t_max, sfc.t_max / 2]
    t1 = np.minimum(t0 + rng.uniform(0, sfc.t_max * 0.01, len(x0)), sfc.t_max)
    want = JXZ3(g=g).index(x0, y0, t0, x1, y1, t1)
    np.testing.assert_array_equal(sfc.index(x0, y0, t0, x1, y1, t1), want)
    hi, lo = sfc.index_hi_lo(*(torch.from_numpy(a) for a in (x0, y0, t0, x1, y1, t1)))
    np.testing.assert_array_equal(_u64(hi.numpy(), lo.numpy()), want.astype(np.uint64))


def test_xz_step_tables_and_refusals_match():
    from geomesa_tpu.curves.xz import XZSFC as JXZ

    from geomesa_tpu_torch.curves.xz import XZSFC

    for g, dims in ((12, 2), (12, 3), (31, 2), (20, 3)):
        np.testing.assert_array_equal(
            XZSFC(g, dims)._step_table().astype(np.uint64), _u64(*JXZ(g, dims)._step_tables()))
    for g, dims in ((0, 2), (32, 2), (21, 3)):
        with pytest.raises(ValueError, match="out of range"):
            XZSFC(g, dims)
    with pytest.raises(ValueError, match="inverted"):
        XZ2SFC().index(np.array([1.0]), np.array([0.0]), np.array([0.0]), np.array([1.0]))


QUERY_BOXES = [
    (-10.0, 35.0, 30.0, 60.0), (2.25, 48.5, 2.75, 49.0), (-180.0, -90.0, 180.0, 90.0),
    (179.5, 89.5, 180.0, 90.0), (0.0, 0.0, 0.0, 0.0), (-45.0, -45.0, -45.0 + 360 * 2**-12, -45.0),
    (10.0, 10.0, 5.0, 5.0),
]


@pytest.mark.parametrize("box", QUERY_BOXES)
@pytest.mark.parametrize("max_ranges", [2000, 128, 7])
def test_xz_ranges_match(box, max_ranges):
    assert XZ2SFC().ranges(*box, max_ranges=max_ranges) == JXZ2().ranges(*box, max_ranges=max_ranges)
    t = (3600.0, 7200.0)
    got = XZ3SFC().ranges(box[0], box[1], t[0], box[2], box[3], t[1], max_ranges=max_ranges)
    assert got == JXZ3().ranges(box[0], box[1], t[0], box[2], box[3], t[1], max_ranges=max_ranges)


WINDOW_MS = [(T0 + 9 * DAY, T0 + 14 * DAY), (T0, T0 + 59 * DAY), (T0 + 3 * DAY, T0 + 3 * DAY),
             (T0 + 5 * DAY, T0 + 4 * DAY), (-20 * DAY, 10 * DAY)]


@pytest.mark.parametrize("box", QUERY_BOXES[:4])
def test_query_bounds_match(box):
    for min_r in (1, 16):
        np.testing.assert_array_equal(
            tz.pad_ranges(tz.xz2_query_bounds(XZ2SFC(), *box), min_r),
            jz.pad_ranges(jz.xz2_query_bounds(JXZ2(), *box), min_r),
        )
    for w in WINDOW_MS:
        got_b, got_i = tz.xz3_query_bounds(XZ3SFC(), *box, *w)
        want_b, want_i = jz.xz3_query_bounds(JXZ3(), *box, *w)
        np.testing.assert_array_equal(got_b, want_b)
        np.testing.assert_array_equal(got_i, want_i)
        assert got_b.dtype == np.uint32 and got_i.dtype == np.int32


def _keys(n, seed, g=12):
    """xz3 codes of random boxes over ~9 week bins, as (hi, lo, bins)."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = _boxes(seed, n)
    ms = rng.integers(T0, T0 + 60 * DAY, len(x0))
    bins, off = to_binned_time(ms, TimePeriod.WEEK)
    offf = off.astype(np.float64)
    c = XZ3SFC(g=g).index(x0, y0, offf, x1, y1, offf).astype(np.uint64)
    c2 = XZ2SFC(g).index(x0, y0, x1, y1).astype(np.uint64)
    split = lambda v: ((v >> np.uint64(32)).astype(np.uint32), (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))  # noqa: E731
    return split(c), split(c2), bins.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("box", QUERY_BOXES[:4])
def test_range_masks_match(box):
    import jax.numpy as jnp

    (h3, l3), (h2, l2), bins = _keys(3000, 7)
    b2 = tz.pad_ranges(tz.xz2_query_bounds(XZ2SFC(), *box))
    got = tz.xz_range_mask(_t(h2), _t(l2), b2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jz.xz_range_mask(jnp.asarray(h2), jnp.asarray(l2), jnp.asarray(b2))))
    count_fn, mask_fn = tz.build_xz_scan(b2, None)
    np.testing.assert_array_equal(mask_fn(_t(h2), _t(l2)).numpy(), got)
    assert int(count_fn(_t(h2), _t(l2))) == got.sum()
    for w in WINDOW_MS[:3]:
        b3, ids = tz.pad_bins(*tz.xz3_query_bounds(XZ3SFC(), *box, *w))
        want = np.asarray(jz.xz3_range_mask(jnp.asarray(h3), jnp.asarray(l3), jnp.asarray(bins),
                                            jnp.asarray(b3), jnp.asarray(ids)))
        got = tz.xz3_range_mask(_t(h3), _t(l3), _t(bins), b3, ids).numpy()
        np.testing.assert_array_equal(got, want)
        count_fn, mask_fn = tz.build_xz_scan(b3, ids)
        np.testing.assert_array_equal(mask_fn(_t(bins), _t(h3), _t(l3)).numpy(), want)
        assert int(count_fn(_t(bins), _t(h3), _t(l3))) == want.sum()


def test_range_masks_match_on_random_words():
    """Any uint64 words and ranges, the padding's lo = 2^64-1 among them
    (it reads as -1 in int64), and ids with gaps."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 4000
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi[:8] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0]
    lo[:8] = [0, 1, 0xFFFFFFFF, 0, 0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    b = rng.integers(0, 2**32, (24, 4), dtype=np.uint64).astype(np.uint32)
    b[:, 0] = np.minimum(b[:, 0], b[:, 2])
    b[:3] = [[0, 0, 0, 1], [0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFFFFFF], [0x7FFFFFFF, 0, 0x80000000, 5]]
    b = tz.pad_ranges(b)  # never-matching padding
    want = np.asarray(jz.xz_range_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(b)))
    np.testing.assert_array_equal(tz.xz_range_mask(_t(hi), _t(lo), b).numpy(), want)
    bins = rng.integers(0, 6, n).astype(np.int32) * 3
    b3 = np.stack([b, b[::-1].copy(), b])
    ids = np.array([0, 9, 15], np.int32)
    want = np.asarray(jz.xz3_range_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bins),
                                        jnp.asarray(b3), jnp.asarray(ids)))
    np.testing.assert_array_equal(tz.xz3_range_mask(_t(hi), _t(lo), _t(bins), b3, ids).numpy(), want)


def test_xz3_range_mask_negative_bin_padding_rule():
    """The counterpart pads xz3 bounds with zeros under id -1, so a row in
    bin -1 with code 0 matches the padding there; the port's masks never
    match an id < 0 (the interleaved scan's rule)."""
    import jax.numpy as jnp

    hi = np.zeros(4, np.uint32)
    lo = np.array([0, 0, 5, 0], np.uint32)
    bins = np.array([-1, 2, 2, 3], np.int32)
    b, ids = tz.pad_bins(np.array([[[0, 0, 0, 10]]], np.uint32), np.array([2], np.int32), 2)
    assert ids.tolist() == [2, -1] and not b[1].any()
    want = np.asarray(jz.xz3_range_mask(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(bins),
                                        jnp.asarray(b), jnp.asarray(ids)))
    got = tz.xz3_range_mask(_t(hi), _t(lo), _t(bins), b, ids).numpy()
    assert want.tolist() == [True, True, True, False]
    assert got.tolist() == [False, True, True, False]
    assert tz.build_xz_scan(b, ids)[1](_t(bins), _t(hi), _t(lo)).tolist() == got.tolist()


@pytest.mark.parametrize("kind", ["xz3", "xz2"])
def test_kind_mask_fn_xz_matches(kind):
    import jax.numpy as jnp

    (h3, l3), (h2, l2), bins = _keys(500, 9)
    box = QUERY_BOXES[0]
    fn, jfn = tz.kind_mask_fn(kind), jz.kind_mask_fn(kind)
    if kind == "xz2":
        b = tz.pad_ranges(tz.xz2_query_bounds(XZ2SFC(), *box))
        got = fn(_t(h2), _t(l2), b)
        want = jfn(jnp.asarray(h2), jnp.asarray(l2), jnp.asarray(b))
    else:
        b, ids = tz.pad_bins(*tz.xz3_query_bounds(XZ3SFC(), *box, *WINDOW_MS[0]))
        got = fn(_t(h3), _t(l3), _t(bins), b, ids)
        want = jfn(jnp.asarray(h3), jnp.asarray(l3), jnp.asarray(bins), jnp.asarray(b), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the resident index --------------------------------------------------------


def test_staged_planes_match(xz3, xz2):
    for jdi, tdi, sft, store in (xz3, xz2):
        assert tdi._z_kind == jdi._z_kind == ("xz3" if sft.dtg_field else "xz2")
        assert not tdi._dim_mode
        names = [Z_HI, Z_LO] + ([Z_BIN] if tdi._z_kind == "xz3" else [])
        _, host, _ = _z_planes_np(store.batch, sft)
        for k in names:
            np.testing.assert_array_equal(tdi._cols[k].numpy(), np.asarray(jdi._cols[k]))
            np.testing.assert_array_equal(tdi._cols[k].numpy(), host[k])
        for k in ("geom__x0", "geom__y0", "geom__x1", "geom__y1"):
            assert tdi._cols[k].dtype == torch.float32
            np.testing.assert_array_equal(tdi._cols[k].numpy(), np.asarray(jdi._cols[k]))
        assert tdi._bin_range == jdi._bin_range
        assert tdi.density("INCLUDE", Envelope(-180, -90, 180, 90), 16, 8) is None


@pytest.mark.parametrize("ecql", XZ3_QUERIES, ids=lambda s: s[:60])
def test_xz3_counts_masks_and_fids_match(xz3, ecql):
    jdi, tdi, _, _ = xz3
    _assert_same(jdi, tdi, ecql)


@pytest.mark.parametrize("ecql", SPATIAL, ids=lambda s: s[:60])
def test_xz2_counts_masks_and_fids_match(xz2, ecql):
    jdi, tdi, _, _ = xz2
    _assert_same(jdi, tdi, ecql)


def test_loose_covers_exact_and_the_exact_path_takes_the_filter_scan(xz3, xz2):
    _, t3, _, _ = xz3
    _, t2, _, _ = xz2
    kernels.reset_counts()
    for tdi, queries in ((t3, XZ3_QUERIES[:15]), (t2, SPATIAL[:5])):
        for q in queries:
            loose, exact = tdi.mask(q, loose=True), tdi.mask(q, loose=False)
            assert not (exact & ~loose).any(), q
            assert tdi.loose_scan_kernel(q) is not None or "10, 10, 5, 5" in q
    assert not any(kernels.DEVICE_FN_CALLS.values())  # every exact scan had a program


def test_stats_count_loose_and_exact_match(xz3, xz2):
    for jdi, tdi, _, _ in (xz3, xz2):
        for q in (SPATIAL[0], XZ3_QUERIES[0] if tdi._z_kind == "xz3" else SPATIAL[2], "INCLUDE"):
            for loose in (True, False):
                spec = 'Count();MinMax("count")'
                assert tdi.stats(q, spec, loose=loose).to_json() == jdi.stats(q, spec, loose=loose).to_json()


def test_from_planes_serves_the_counterparts_planes(xz3, xz2):
    for jdi, tdi, sft, store in (xz3, xz2):
        planes = planes_from_numpy({k: np.asarray(v) for k, v in jdi._cols.items()}, "cpu")
        fdi = DeviceIndex.from_planes(sft, store.batch, planes, None, jdi._bin_range, device="cpu")
        assert fdi._z_kind == tdi._z_kind
        for q in (XZ3_QUERIES[:6] + XZ3_QUERIES[-9:-4]) if tdi._z_kind == "xz3" else SPATIAL[:8]:
            _assert_same(jdi, fdi, q)


LABELS = ["", "A", "B", "A&B", "A|C"]


@pytest.fixture(scope="module")
def labeled():
    return _pair(XZ2_SPEC, _columns(800, seed=13, with_dtg=False, labels=LABELS))


@pytest.mark.parametrize("auths", [(), ("A",), ("A", "B", "C")], ids=repr)
def test_auths_match(labeled, auths):
    jdi, tdi, _, _ = labeled
    for q in (SPATIAL[0], SPATIAL[7], "INCLUDE"):
        _assert_same(jdi, tdi, q, auths=auths)
    spec = "Count()"
    assert (tdi.stats(SPATIAL[0], spec, loose=True, auths=auths).to_json()
            == jdi.stats(SPATIAL[0], spec, loose=True, auths=auths).to_json())


def test_density_is_none_and_the_store_path_answers_as_the_counterpart(xz2):
    from geomesa_tpu.filter import ast as jast
    from geomesa_tpu.process.density import density as jdensity

    from geomesa_tpu_torch.process.density import density

    jdi, tdi, _, store = xz2
    env = Envelope(-180, -90, 180, 90)
    assert tdi.density(SPATIAL[0], env, 32, 16) is None
    with pytest.raises(TypeError, match="not a Point column"):
        jdensity(jdi.store, "p", jast.Include, env, 32, 16, device_index=jdi, use_device=False)
    with pytest.raises(TypeError, match="not a Point column"):
        density(store, "p", "INCLUDE", env, 32, 16, device_index=tdi, device="cpu")


def test_loose_xz3_window_before_1970_takes_the_exact_scan():
    """Rows in bins before 1970 have negative ids, which the range masks
    read as padding: a loose window over such a bin must go to the exact
    scan, and answers as the counterpart does."""
    cols = _columns(400, seed=14)
    cols["dtg"] = cols["dtg"] - (T0 + 14 * DAY) + np.random.default_rng(1).integers(-28, 28, 400) * DAY // 2
    jdi, tdi, _, _ = _pair(XZ3_SPEC, cols)
    assert tdi._bin_range[0] < 0 <= tdi._bin_range[1]
    q = "BBOX(geom, -180, -90, 180, 90) AND dtg DURING 1969-12-20T00:00:00Z/1970-01-10T00:00:00Z"
    assert tdi._loose_bounds(tdi._parse(q)) is None
    exact = tdi.mask(q, loose=False)
    np.testing.assert_array_equal(tdi.mask(q, loose=True), exact)
    assert exact.sum() == jdi.count(q, loose=False) > 0
    later = "BBOX(geom, -180, -90, 180, 90) AND dtg DURING 1970-01-12T00:00:00Z/1970-01-20T00:00:00Z"
    assert tdi._loose_bounds(tdi._parse(later))[0] == "xz"
    _assert_same(jdi, tdi, later)


def test_float32_envelope_probe():
    """An envelope edge within one float32 ulp of a query edge. The
    counterpart stages envelope planes as float32 lanes on a TPU, rounded
    to nearest, and the port does so always; a row whose float64 edge lies
    just outside a query box can round onto its edge. Recorded here: what
    the host predicate (float64), the port and the counterpart fed float32
    planes answer for such rows."""
    import jax.numpy as jnp

    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
    from geomesa_tpu.filter.compile import compile_filter as jcompile
    from geomesa_tpu.filter.ecql import parse_ecql as jparse
    from geomesa_tpu.ops.scan import stage_columns as jstage

    from geomesa_tpu_torch.filter.compile import compile_filter, evaluate_host
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops.scan import stage_columns

    edge = 10.0
    below = float(np.nextafter(np.float32(edge), np.float32(0)))  # one float32 ulp inside
    off = edge - 2.0**-30  # float64: just below 10, rounds to 10.0 in float32
    rows = [
        f"POLYGON (({off} 0, {off - 1} 0, {off - 1} 1, {off} 1, {off} 0))",  # xmax < 10 in float64
        f"POLYGON (({below} 0, {below - 1} 0, {below - 1} 1, {below} 1, {below} 0))",
        "POLYGON ((10 0, 9 0, 9 1, 10 1, 10 0))",  # exactly on the edge
    ]
    ecql = f"BBOX(geom, {edge}, 0, 20, 1)"
    spec = "*geom:Polygon:srid=4326"
    sft, jsft = SimpleFeatureType.create("p", spec), JSFT.create("p", spec)
    batch = FeatureBatch.from_columns(sft, {"geom": np.array(rows, dtype=object)})
    jbatch = JBatch.from_columns(jsft, {"geom": np.array(rows, dtype=object)})
    host = evaluate_host(parse_ecql(ecql), batch)
    cf = compile_filter(parse_ecql(ecql), sft)
    port = cf.mask(stage_columns(batch, cf.device_cols, "cpu")).numpy()
    jcf = jcompile(jparse(ecql), jsft)
    jplanes = {k: jnp.asarray(v) for k, v in jstage(jbatch, jcf.device_cols, dtype=np.float32).items()}
    ref32 = np.asarray(jcf.device_fn(jplanes))
    assert host.tolist() == [False, False, True]  # float64: only the edge row touches x = 10
    # float32 lanes: the row 2^-30 short of the edge rounds onto it, in
    # both packages alike; the row one float32 ulp short stays out
    assert port.tolist() == ref32.tolist() == [True, False, True]
    # rounding to nearest is monotonic, so a compare of two rounded values
    # can gain a row at an edge but never lose one the float64 answer keeps
    assert not (host & ~port).any()
    # served: BBOX alone is fully on the device, so the resident count has
    # the gained row; an INTERSECTS keeps the envelope as a prefilter only,
    # and its float64 host residual drops the row again
    di = DeviceIndex(BatchStore(batch), "p", z_planes=True, device="cpu")
    assert di.count(ecql) == 2 and di.count(ecql, loose=True) >= 2
    inter = "INTERSECTS(geom, POLYGON((10 0, 20 0, 20 1, 10 1, 10 0)))"
    assert di.mask(inter).tolist() == evaluate_host(parse_ecql(inter), batch).tolist() == [False, False, True]
