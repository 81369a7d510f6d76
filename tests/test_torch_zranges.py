"""Port parity for the z-range decomposition: ``geomesa_tpu_torch``'s
``curves/zranges.py`` and the ``ranges`` of its Z3, Z2, XZ2 and XZ3
curves against ``geomesa_tpu``'s, range for range.

The JAX package's ``zranges`` takes its native C++ decomposition when that
is built and its Python one otherwise (the two are bit-identical by its
own contract); both are compared where they differ in path. Boxes and
windows come from ``np.random.default_rng`` seeds plus hand-written edges:
the lon = 180 / lat = 90 corner, tiny boxes at the antimeridian, inverted
and empty boxes, offsets at the period's edges (0 and 604,800 s a week),
and budgets from 1 to the default 2000. Tolerance: equal.
"""

import importlib

import numpy as np
import pytest

from geomesa_tpu.curves.binnedtime import TimePeriod as JPeriod
from geomesa_tpu.curves.xz2 import XZ2SFC as JXZ2
from geomesa_tpu.curves.xz3 import XZ3SFC as JXZ3
from geomesa_tpu.curves.z2 import Z2SFC as JZ2
from geomesa_tpu.curves.z3 import Z3SFC as JZ3
from geomesa_tpu_torch.curves import zranges as tzr
from geomesa_tpu_torch.curves.binnedtime import TimePeriod
from geomesa_tpu_torch.curves.xz2 import XZ2SFC
from geomesa_tpu_torch.curves.xz3 import XZ3SFC
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC

# the JAX package's curves/__init__ re-exports the function under the module's name
jzr = importlib.import_module("geomesa_tpu.curves.zranges")
WEEK_S = 604_800


def _same(got, want):
    assert [tuple(r) for r in got] == [tuple(r) for r in want]


def _random_box(rng, dims, bits):
    hi = (1 << bits) - 1
    a = rng.integers(-3, hi + 4, dims)
    span = rng.integers(0, max(2, (hi + 1) >> rng.integers(0, bits)), dims)
    return [int(v) for v in a], [int(v) for v in a + span]


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("dims,bits", [(2, 4), (2, 11), (3, 5), (3, 9), (2, 31), (3, 21)])
def test_zranges_equal_the_reference(seed, dims, bits):
    rng = np.random.default_rng(seed * 100 + dims * 10 + bits)
    for max_ranges in (1, 7, 64, 2000):
        qlo, qhi = _random_box(rng, dims, bits)
        got = tzr.zranges(qlo, qhi, bits, max_ranges)
        _same(got, jzr.zranges(qlo, qhi, bits, max_ranges, use_native=False))
        _same(got, jzr.zranges(qlo, qhi, bits, max_ranges))
        rec = int(rng.integers(1, 6))
        _same(tzr.zranges(qlo, qhi, bits, max_ranges, max_recurse=rec),
              jzr.zranges(qlo, qhi, bits, max_ranges, max_recurse=rec, use_native=False))


def test_zranges_edges_and_merge():
    assert tzr.zranges([5, 5], [4, 9], 4) == []  # inverted
    assert tzr.zranges([0], [0], 8) == jzr.zranges([0], [0], 8, use_native=False)
    with pytest.raises(ValueError):
        tzr.zranges([0, 0], [1], 4)
    full = tzr.zranges([0, 0, 0], [7, 7, 7], 3)
    assert full == [tzr.IndexRange(0, 511, True)]
    rs = [tzr.IndexRange(0, 3, True), tzr.IndexRange(4, 6, False), tzr.IndexRange(10, 11, True),
          tzr.IndexRange(20, 30, True), tzr.IndexRange(33, 40, True)]
    jrs = [jzr.IndexRange(*r) for r in rs]
    for budget in (1, 2, 3, 10):
        _same(tzr._merge(list(rs), budget), jzr._merge(list(jrs), budget))


Z3_BOXES = [  # (xmin, ymin, xmax, ymax, tmin, tmax) in degrees and week seconds
    (-10.0, 35.0, 30.0, 60.0, 0.0, WEEK_S),
    (179.5, 89.5, 180.0, 90.0, 0.0, 10.0),  # the corner: clamps to the max index
    (179.9999, -1.0, 180.0, 1.0, 302_400.0, 302_400.0),  # the antimeridian, one second
    (-180.0, -1.0, -179.9999, 1.0, 604_799.0, WEEK_S),  # the period's last seconds
    (-180.0, -90.0, 180.0, 90.0, 0.0, WEEK_S),  # the whole domain
    (2.25, 48.8125, 2.4375, 48.90625, 3600.0, 90_000.0),  # a city, one day
    (10.0, 10.0, 5.0, 20.0, 0.0, 100.0),  # inverted in x
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),  # a point
]


@pytest.mark.parametrize("box", Z3_BOXES, ids=range(len(Z3_BOXES)))
@pytest.mark.parametrize("max_ranges", [1, 16, 400, 2000])
def test_z3_ranges_equal_the_reference(box, max_ranges):
    for period, jperiod in ((TimePeriod.WEEK, JPeriod.WEEK), (TimePeriod.DAY, JPeriod.DAY)):
        t = Z3SFC(period).time.max
        b = box[:4] + (min(box[4], t), min(box[5], t))
        _same(Z3SFC(period).ranges(*b, max_ranges=max_ranges),
              JZ3(jperiod).ranges(*b, max_ranges=max_ranges))


@pytest.mark.parametrize("seed", range(8))
def test_z3_and_z2_random_boxes_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        cx, cy = rng.uniform(-180, 180), rng.uniform(-90, 90)
        hx, hy = 10.0 ** rng.uniform(-4, 1.5, 2)
        t0 = float(rng.integers(0, WEEK_S))
        t1 = t0 + float(rng.integers(0, WEEK_S))
        budget = int(rng.choice([8, 100, 2000]))
        _same(Z3SFC().ranges(cx - hx, cy - hy, cx + hx, cy + hy, t0, t1, max_ranges=budget),
              JZ3().ranges(cx - hx, cy - hy, cx + hx, cy + hy, t0, t1, max_ranges=budget))
        _same(Z2SFC().ranges(cx - hx, cy - hy, cx + hx, cy + hy, max_ranges=budget),
              JZ2().ranges(cx - hx, cy - hy, cx + hx, cy + hy, max_ranges=budget))


@pytest.mark.parametrize("box", [b[:4] for b in Z3_BOXES], ids=range(len(Z3_BOXES)))
@pytest.mark.parametrize("max_ranges", [1, 16, 2000])
def test_z2_ranges_equal_the_reference(box, max_ranges):
    _same(Z2SFC().ranges(*box, max_ranges=max_ranges), JZ2().ranges(*box, max_ranges=max_ranges))
    _same(Z2SFC().ranges(*box, max_ranges=max_ranges, max_recurse=3),
          JZ2().ranges(*box, max_ranges=max_ranges, max_recurse=3))


@pytest.mark.parametrize("seed", range(4))
def test_xz_ranges_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 4))
    c = rng.uniform([-170, -80], [170, 80], (k, 2))
    h = 10.0 ** rng.uniform(-3, 1, (k, 2))
    x0, y0, x1, y1 = c[:, 0] - h[:, 0], c[:, 1] - h[:, 1], c[:, 0] + h[:, 0], c[:, 1] + h[:, 1]
    for budget in (16, 2000):
        _same(XZ2SFC().ranges(x0, y0, x1, y1, max_ranges=budget),
              JXZ2().ranges(x0, y0, x1, y1, max_ranges=budget))
        t0 = np.full(k, float(rng.integers(0, WEEK_S // 2)))
        t1 = t0 + float(rng.integers(0, WEEK_S // 2))
        _same(XZ3SFC().ranges(x0, y0, t0, x1, y1, t1, max_ranges=budget),
              JXZ3().ranges(x0, y0, t0, x1, y1, t1, max_ranges=budget))
