"""Port parity for stats: ``geomesa_tpu_torch``'s ``DeviceIndex.stats``
(device reductions on the pushdown hook, host sketches for the rest)
against ``geomesa_tpu``'s, compared through ``to_json()``.

Inputs come from ``np.random.default_rng`` with float32-exact values, so
the JAX package's float64 planes on the CPU and the port's float32 planes
give the same MinMax and the same histogram bins. Tolerance: equal.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
SPEC = "count:Int,val:Double,dtg:Date,name:String,*geom:Point:srid=4326"
EXACT = "BBOX(geom, -30, -20, 40, 30) AND dtg DURING 2020-01-05T00:00:00Z/2020-02-10T00:00:00Z"
FILTERS = [  # (filter, loose)
    (EXACT, False),
    (EXACT, True),
    ("INCLUDE", None),
    ("BBOX(geom, -30, -20, 40, 30) AND name LIKE 'b%'", None),
]
SPECS = [
    "Count()",
    'MinMax("count")',
    'MinMax("dtg")',
    'Histogram("count",20,0,1000)',
    'Histogram("val",16,0.5,2.0)',
]
COMBINED = ";".join(SPECS + ['MinMax("val")', 'MinMax("name")', 'MinMax("geom")'])


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    # 60 days from 2020-01-01 cross a high-word boundary (368 << 32), so
    # MinMax("dtg") exercises the lexicographic (hi, lo) reduction
    dtg = rng.integers(T0, T0 + 60 * DAY, n)
    assert (dtg >> 32).min() < (dtg >> 32).max()
    return {
        "count": rng.integers(0, 1000, n),
        "val": rng.uniform(0.25, 2.5, n).astype(np.float32).astype(np.float64),
        "dtg": dtg,
        "name": np.array(["a", "b", "c"] * (n // 3) + ["a"] * (n % 3), dtype=object),
        "geom": rng.uniform([-60, -40], [60, 40], (n, 2)).astype(np.float32).astype(np.float64),
    }


def _pair(cols):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    jsft, sft = JSFT.create("t", SPEC), SimpleFeatureType.create("t", SPEC)
    jdi = JIndex(JStore(JBatch.from_columns(jsft, cols)), "t", z_planes=True)
    tdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(sft, cols)), "t",
                      z_planes=True, device="cpu")
    return jdi, tdi


@pytest.fixture(scope="module")
def pair():
    return _pair(_columns(5003, seed=21))


@pytest.mark.parametrize("case", FILTERS, ids=lambda c: f"{c[0][:20]}-{c[1]}")
def test_combined_spec_matches(pair, case):
    jdi, tdi = pair
    f, loose = case
    want = jdi.stats(f, COMBINED, loose=loose).to_json()
    assert tdi.stats(f, COMBINED, loose=loose).to_json() == want
    assert want[0]["count"] > 0


@pytest.mark.parametrize("spec", SPECS)
def test_each_spec_matches(pair, spec):
    jdi, tdi = pair
    assert tdi.stats(EXACT, spec).to_json() == jdi.stats(EXACT, spec).to_json()


def test_no_hits_and_empty_index(pair):
    jdi, tdi = pair
    none = "BBOX(geom, 170, 80, 179, 89)"
    assert tdi.stats(none, COMBINED).to_json() == jdi.stats(none, COMBINED).to_json()
    ejdi, etdi = _pair({k: v[:0] for k, v in _columns(10, seed=1).items()})
    assert len(etdi) == 0
    assert etdi.stats("INCLUDE", COMBINED).to_json() == ejdi.stats("INCLUDE", COMBINED).to_json()


def test_stats_go_through_the_kernel_wrappers(pair):
    """The exact filter's mask comes from the filter-scan wrapper (its
    plain version on CPU tensors: no launches), never from device_fn."""
    _, tdi = pair
    kernels.reset_counts()
    tdi.stats(EXACT, COMBINED)
    tdi.stats(EXACT, COMBINED, loose=True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels.DEVICE_FN_CALLS == {"count": 0, "mask": 0}


def test_sketches_merge_and_parse():
    a, b = parse_stat(COMBINED), parse_stat(COMBINED)
    vals = np.array([3.0, 1.0, 2.0])
    a.stats[1].observe(vals)
    b.stats[1].observe(np.array([5.0]))
    b.stats[3].observe(np.array([10.0, 990.0, 5000.0]))
    a.merge(b)
    assert a.stats[1].to_json()["min"] == 1.0 and a.stats[1].to_json()["max"] == 5.0
    assert a.stats[1].count == 4
    assert a.stats[3].counts.sum() == 3 and a.stats[3].counts[-1] == 2
    # the host sketches parse as in the JAX package (tests/test_torch_sketches.py
    # holds their answers against it)
    from geomesa_tpu.stats import parse_stat as jparse

    for spec in ('Cardinality("name")', 'Frequency("name")', 'Z3Histogram("geom","dtg")',
                 'TopK("name",3)'):
        assert parse_stat(spec).to_json() == jparse(spec).to_json()
    with pytest.raises(ValueError, match="unknown stat"):
        parse_stat("Nope()")
