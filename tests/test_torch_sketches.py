"""Port parity for the host sketches: ``geomesa_tpu_torch``'s
``stats/sketches.py`` (Cardinality, TopK, Frequency, Histogram,
Z3Histogram, Count, MinMax), its Stat DSL and JSON codec against
``geomesa_tpu``'s, compared through ``to_json()`` after ``observe`` and
``merge``, and the planner-facing estimates.

Inputs come from ``np.random.default_rng`` seeds: integer, float, string
and date columns, with heavy hitters and repeats. Tolerance: equal
(estimates bit for bit: both are the same float64 numpy).
"""

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.stats import parse_stat as jparse
from geomesa_tpu.stats import sketches as js
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.stats import sketches as ts

T0 = 1_577_836_800_000
DAY = 86_400_000
SPEC = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
ALL = ('Count();MinMax("count");MinMax("dtg");Cardinality("name");Cardinality("count");'
       'TopK("name",5);TopK("count");Frequency("name");Frequency("val");'
       'Histogram("val",16,0,10);Z3Histogram("geom","dtg");Z3Histogram("geom","dtg","day")')


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    names = np.array([f"n{i}" for i in range(200)], dtype=object)
    heavy = rng.random(n) < 0.3
    return {
        "name": np.where(heavy, "hot", names[rng.integers(0, 200, n)]).astype(object),
        "count": rng.zipf(1.5, n).clip(0, 10_000),
        "val": np.round(rng.uniform(0, 12, n), 3),
        "dtg": T0 + rng.integers(0, 40 * DAY, n),
        "geom": rng.uniform([-180, -90], [180, 90], (n, 2)),
    }


def _batches(n, seed):
    cols = _columns(n, seed)
    return (FeatureBatch.from_columns(SimpleFeatureType.create("t", SPEC), cols),
            JBatch.from_columns(JSFT.create("t", SPEC), cols))


@pytest.mark.parametrize("n", [0, 1, 997, 1 << 14])
def test_dsl_observe_batch_equals_the_reference(n):
    tb, jb = _batches(n, seed=n)
    got, want = parse_stat(ALL), jparse(ALL)
    got.observe_batch(tb)
    want.observe_batch(jb)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("seed", range(3))
def test_merge_equals_the_reference(seed):
    tb1, jb1 = _batches(3001, seed)
    tb2, jb2 = _batches(5003, seed + 10)
    got, want = parse_stat(ALL), jparse(ALL)
    got.observe_batch(tb1)
    want.observe_batch(jb1)
    g2, w2 = parse_stat(ALL), jparse(ALL)
    g2.observe_batch(tb2)
    w2.observe_batch(jb2)
    got.merge(g2)
    want.merge(w2)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("kind", ["cardinality", "topk", "frequency", "z3histogram", "histogram"])
def test_each_sketch_observe_merge_and_estimates(kind):
    cols = _columns(20_000, seed=5)
    if kind == "cardinality":
        make = [lambda m: m.Cardinality("a"), lambda m: m.Cardinality("a", p=8)]
        feeds = [cols["count"], cols["name"], cols["val"]]
    elif kind == "topk":
        make = [lambda m: m.TopK("a", 3), lambda m: m.TopK("a", 1)]
        feeds = [cols["name"], cols["count"]]
    elif kind == "frequency":
        make = [lambda m: m.Frequency("a"), lambda m: m.Frequency("a", 2, 64)]
        feeds = [cols["name"], cols["count"], cols["val"]]
    elif kind == "histogram":
        make = [lambda m: m.Histogram("a", 12, 0.0, 10.0)]
        feeds = [cols["val"]]
    else:
        make = [lambda m: m.Z3HistogramStat("g", "d"), lambda m: m.Z3HistogramStat("g", "d", "day", 9)]
        feeds = [None]
    for mk in make:
        for feed in feeds:
            got, want = mk(ts), mk(js)
            half = len(cols["dtg"]) // 2
            parts = [slice(0, half), slice(half, None)]
            g2, w2 = mk(ts), mk(js)
            for stat, jstat, sl in ((got, want, parts[0]), (g2, w2, parts[1])):
                if kind == "z3histogram":
                    x, y = cols["geom"][sl, 0], cols["geom"][sl, 1]
                    stat.observe_xyt(x, y, cols["dtg"][sl])
                    jstat.observe_xyt(x, y, cols["dtg"][sl])
                else:
                    stat.observe(feed[sl])
                    jstat.observe(feed[sl])
            got.merge(g2)
            want.merge(w2)
            assert got.to_json() == want.to_json()
            back = ts.stat_from_json(got.to_json())
            assert back.to_json() == got.to_json()
            if kind == "cardinality":
                assert got.estimate == want.estimate
            elif kind == "topk":
                assert got.topk == want.topk
            elif kind == "frequency":
                for v in feed[:20]:
                    assert got.count(v) == want.count(v)
            elif kind == "z3histogram":
                envs = [((Envelope(-10, 35, 30, 60), None)), (Envelope(100, -40, 150, 0), None)]
                jenvs = [(JEnvelope(*(e.xmin, e.ymin, e.xmax, e.ymax)), None) for e, _ in envs]
                ivals = [(T0 + DAY, T0 + 9 * DAY), (T0 + 20 * DAY, T0 + 21 * DAY)]
                assert got.estimate(envs, ivals) == want.estimate(jenvs, ivals)
                assert got.estimate_spatial(envs) == want.estimate_spatial(jenvs)


def test_json_codec_round_trips_every_sketch():
    tb, jb = _batches(4099, seed=3)
    got = parse_stat(ALL)
    got.observe_batch(tb)
    back = ts.seq_from_json(got.to_json())
    assert back.to_json() == got.to_json()
    assert js.seq_from_json(got.to_json()).to_json() == got.to_json()
    with pytest.raises(ValueError, match="unknown stat json"):
        ts.stat_from_json({"type": "nope"})
    with pytest.raises(TypeError):
        ts.Z3HistogramStat("g", "d").observe(np.zeros(3))
