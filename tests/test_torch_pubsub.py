"""The port's continuous-query push tier (``geomesa_tpu_torch/pubsub/``)
against the JAX package's (``geomesa_tpu/pubsub/``), on the CPU, the port's
stores on ``device="cpu"``; the non-replication cases of
``tests/test_pubsub.py``, each run in both packages.

- The registry: subscription parsing and validation, the envelope of
  bbox / dwithin / cql predicates, persistence and recovery, the cap per
  type; a registry root written by either package recovers in the other
  (the WAL's JSON op records are the same bytes).
- The matcher: ``[(sub, rows)]`` equal to the JAX package's by
  registration order, for bbox / cql / dwithin / visibility, and over a
  seeded random case (200 subscriptions of random ECQL trees, bboxes,
  dwithins and auths x 20 append batches, 10 seeds), on the host engine
  and on the device engine's torch ops (``join.engine=device``); one fused
  join a batch (``launches``); the layout on the store's device.
- The hub, each scenario in both packages with the same appends:
  exactly-once resume across a disconnect, the slow consumer's overflow
  teardown and its replay, a match fault that never un-acks an append,
  the retention floor pinning then ageing out, a cursor below the
  compacted tail (``CursorGoneError``), the commit gate's hold and flush.
- The live layer's retention floor holds a compaction's WAL truncation.
"""

import math
import time

import numpy as np
import pytest
from _torch_fs_cases import AUTHS, props, random_ecql, rows

from geomesa_tpu import failpoints as jfp
from geomesa_tpu.conf import prop_override as jprop_override
from geomesa_tpu.features import FeatureBatch as JFeatureBatch
from geomesa_tpu.features import SimpleFeatureType as JSFT
from geomesa_tpu.pubsub import CursorGoneError as JCursorGone
from geomesa_tpu.pubsub import PubSubHub as JHub
from geomesa_tpu.pubsub.matcher import SubscriptionMatcher as JMatcher
from geomesa_tpu.pubsub.registry import Subscription as JSubscription
from geomesa_tpu.pubsub.registry import SubscriptionRegistry as JRegistry
from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu.store.stream import StreamingStore as JStreamingStore
from geomesa_tpu_torch import failpoints
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.pubsub import CursorGoneError, PubSubHub
from geomesa_tpu_torch.pubsub.matcher import SubscriptionMatcher
from geomesa_tpu_torch.pubsub.registry import Subscription, SubscriptionRegistry
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.store.stream import StreamingStore

SPEC = "val:Int,dtg:Date,*geom:Point:srid=4326"
Z3 = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"


def _cols(pts, vals=None):
    pts = np.asarray(pts, dtype=float)
    n = len(pts)
    return {"val": np.asarray(vals if vals is not None else range(n)),
            "dtg": np.arange(n) + 1000, "geom": pts}


def _stores(tmp_path):
    """(port store, JAX store) under ``tmp_path``, a type ``t`` of SPEC."""
    t = FileSystemDataStore(str(tmp_path / "port"), partition_size=128, device="cpu")
    j = JFS(str(tmp_path / "jax"), partition_size=128)
    for ds in (t, j):
        ds.create_schema("t", SPEC)
    return t, j


# -- the registry ------------------------------------------------------------


@pytest.mark.parametrize("doc", [
    {"bbox": [10, 0, 0, 10]}, {"bbox": [0, 0, 10]}, {}, {"cql": "val >"},
    {"dwithin": {"x": 0, "y": 0}}, {"dwithin": {"x": 0, "y": 0, "distance": -1}},
    {"bbox": "nope"}, [1, 2],
])
def test_subscription_parse_refuses_as_the_reference(doc):
    sft, jsft = SimpleFeatureType.create("t", SPEC), JSFT.create("t", SPEC)
    with pytest.raises(ValueError) as te:
        Subscription.parse("t", doc, sft, tenant="tn", auths=(), created_seq=-1)
    with pytest.raises(ValueError) as je:
        JSubscription.parse("t", doc, jsft, tenant="tn", auths=(), created_seq=-1)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("doc", [
    {"bbox": [0, 0, 10, 10], "cql": "val > 5"},
    {"bbox": [0, 0, 10, 10], "dwithin": {"x": 2, "y": 2, "distance": 1}},
    {"bbox": [0, 0, 1, 1], "dwithin": {"x": 50, "y": 50, "distance": 1}},
    {"cql": "BBOX(geom, 1, 2, 3, 4) OR BBOX(geom, -5, -6, 0, 1)"},
    {"cql": "INTERSECTS(geom, POLYGON((0 0, 4 0, 2 3, 0 0))) AND val < 3"},
    {"cql": "DWITHIN(geom, POINT(1 1), 2, kilometers)", "bbox": [-10, -10, 10, 10]},
    {"filter": "val BETWEEN 1 AND 4"},
    {"dwithin": {"x": 179.5, "y": 89.5, "distance": 2}},
])
def test_subscription_envelope_and_doc_equal_the_reference(doc):
    sft, jsft = SimpleFeatureType.create("t", SPEC), JSFT.create("t", SPEC)
    a = Subscription.parse("t", doc, sft, tenant="x", auths=("A",), created_seq=3)
    b = JSubscription.parse("t", doc, jsft, tenant="x", auths=("A",), created_seq=3)
    assert len(a.sub_id) == 12
    np.testing.assert_array_equal(a.envelope(), b.envelope())
    da, db = a.to_doc(), b.to_doc()
    da.pop("id"), db.pop("id")
    assert da == db
    assert Subscription.from_doc(a.to_doc()) == a
    if doc.get("dwithin", {}).get("x") == 50:
        assert all(math.isnan(v) for v in a.envelope())


def _docs(seed: int, n: int, kind: str = "z3", cap_auths=True) -> list:
    """n seeded subscription docs over the predicate mix: bbox, random ECQL
    trees (with or without a bbox), dwithin, and random auths."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {}
        pick = rng.integers(0, 5)
        if pick in (0, 1, 4):
            x0, y0 = float(rng.integers(-180, 150)), float(rng.integers(-90, 60))
            doc["bbox"] = [x0, y0, x0 + float(rng.integers(1, 60)), y0 + float(rng.integers(1, 40))]
        if pick in (1, 2):
            doc["cql"] = random_ecql(rng, kind, depth=2)
        if pick in (3, 4):
            doc["dwithin"] = {"x": float(rng.integers(-150, 150)), "y": float(rng.integers(-60, 60)),
                              "distance": float(rng.integers(1, 40))}
        if not doc:
            doc["bbox"] = [-180.0, -90.0, 180.0, 90.0]
        auths = AUTHS[rng.integers(0, len(AUTHS))] if cap_auths else None
        out.append((f"s{i:04d}", doc, auths))
    return out


def _register(reg, sub_cls, sft, docs, created_seq=-1):
    for sid, doc, auths in docs:
        s = sub_cls.parse("t", doc, sft, tenant=f"tn{sid}", auths=auths, created_seq=created_seq)
        d = s.to_doc()
        d["id"] = sid  # the same ids in both packages
        reg.subscribe(sub_cls.from_doc(d))


def test_registry_persists_and_recovers_as_the_reference(tmp_path):
    sft, jsft = SimpleFeatureType.create("t", SPEC), JSFT.create("t", SPEC)
    docs = _docs(3, 12)
    regs = SubscriptionRegistry(str(tmp_path / "p")), JRegistry(str(tmp_path / "j"))
    for reg, cls, s in zip(regs, (Subscription, JSubscription), (sft, jsft)):
        _register(reg, cls, s, docs, created_seq=4)
        assert reg.unsubscribe("s0003") and not reg.unsubscribe("s0003")
    assert regs[0].list() == regs[1].list()
    assert regs[0].gen == regs[1].gen == 13 and regs[0].count("t") == 11
    assert regs[0].for_type("t")[0].sub_id == "s0000"
    st = [dict(r.stats()) for r in regs]
    for d in st:
        d["wal"] = {k: v for k, v in d["wal"].items() if k != "dir"}
    assert st[0] == st[1]
    for r in regs:
        r.close()
    again = SubscriptionRegistry(str(tmp_path / "p")), JRegistry(str(tmp_path / "j"))
    assert again[0].list() == again[1].list() == regs[0].list()
    assert again[0].gen == again[1].gen
    got = again[0].get("s0005")
    assert got is not None and got.created_seq == 4 and got.tenant == "tns0005"
    for r in again:
        r.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_registry_root_recovers_in_the_other_package(tmp_path, writer):
    """The registry WAL holds the same op records: a root written by one
    package recovers in the other, subscription for subscription."""
    sft, jsft = SimpleFeatureType.create("t", SPEC), JSFT.create("t", SPEC)
    root = str(tmp_path / "root")
    docs = _docs(4, 9)
    w = JRegistry(root) if writer == "jax" else SubscriptionRegistry(root)
    _register(w, JSubscription if writer == "jax" else Subscription,
              jsft if writer == "jax" else sft, docs, created_seq=2)
    w.unsubscribe("s0001")
    want, gen = w.list(), w.gen
    w.close()
    r = SubscriptionRegistry(root) if writer == "jax" else JRegistry(root)
    assert r.list() == want and r.gen == gen
    assert r.next_seq == 10
    # and both packages' segment bytes agree for the same ops
    other = str(tmp_path / "other")
    o = SubscriptionRegistry(other) if writer == "jax" else JRegistry(other)
    _register(o, Subscription if writer == "jax" else JSubscription,
              sft if writer == "jax" else jsft, docs, created_seq=2)
    o.unsubscribe("s0001")
    assert list(o.wal.read_from(-1)) == list(r.wal.read_from(-1))
    r.close()
    o.close()


def test_registry_cap_per_type_and_apply_replicated(tmp_path):
    sft, jsft = SimpleFeatureType.create("t", SPEC), JSFT.create("t", SPEC)
    regs = SubscriptionRegistry(str(tmp_path / "p")), JRegistry(str(tmp_path / "j"))
    with props(sub_max_per_type=2):
        errs = []
        for reg, cls, s in zip(regs, (Subscription, JSubscription), (sft, jsft)):
            for _ in range(2):
                reg.subscribe(cls.parse("t", {"bbox": [0, 0, 5, 5]}, s, tenant="a", auths=(),
                                        created_seq=-1))
            with pytest.raises(ValueError) as e:
                reg.subscribe(cls.parse("t", {"bbox": [0, 0, 5, 5]}, s, tenant="a", auths=(),
                                        created_seq=-1))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    rec = next(iter(regs[1].wal.read_from(-1)))
    with pytest.raises(NotImplementedError, match="item 7"):
        regs[0].apply_replicated(*rec)
    for r in regs:
        r.close()


# -- the matcher ---------------------------------------------------------------


def _batches(kind: str, n: int, seed: int, labels: bool):
    """(port batch, JAX batch) of the same seeded rows."""
    cols = rows(kind, n, seed, labels=labels)
    vis = cols.pop(VIS_COLUMN, None)
    fids = np.arange(n) + seed * 1000
    t = FeatureBatch.from_columns(SimpleFeatureType.create("t", Z3), cols, fids)
    j = JFeatureBatch.from_columns(JSFT.create("t", Z3), cols, fids)
    if vis is not None:
        t, j = t.with_visibility(list(vis)), j.with_visibility(list(vis))
    return t, j


def _same_matches(got, want):
    assert [s.sub_id for s, _ in got] == [s.sub_id for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.fixture(params=["auto", "device"], ids=["host-engine", "device-engine"])
def engine(request):
    with prop_override("join.engine", request.param):
        yield request.param


def _matchers(tmp_path, docs):
    sft, jsft = SimpleFeatureType.create("t", Z3), JSFT.create("t", Z3)
    regs = SubscriptionRegistry(str(tmp_path / "p")), JRegistry(str(tmp_path / "j"))
    _register(regs[0], Subscription, sft, docs)
    _register(regs[1], JSubscription, jsft, docs)
    return (SubscriptionMatcher(regs[0], device="cpu"), JMatcher(regs[1]), sft, jsft, regs)


def test_residuals_bbox_cql_dwithin_visibility_equal_the_reference(tmp_path, engine):
    docs = [("box", {"bbox": [0, 0, 10, 10]}, None),
            ("cql", {"bbox": [0, 0, 10, 10], "cql": "count > 50"}, None),
            ("dw", {"dwithin": {"x": 0, "y": 0, "distance": 1.0}}, None),
            ("vis", {"bbox": [0, 0, 10, 10]}, ("A",)),
            ("none", {"bbox": [100, 0, 110, 10]}, None),
            ("empty", {"bbox": [0, 0, 1, 1], "dwithin": {"x": 50, "y": 50, "distance": 1}}, None)]
    tm, jm, sft, jsft, regs = _matchers(tmp_path, docs)
    pts = [[5, 5], [6, 6], [120, 40], [0.9, 0.9], [0.5, 0.0], [0.25, 0.25]]
    cols = {"name": np.array(["a"] * 6, object), "count": np.array([10, 90, 90, 0, 0, 60]),
            "val": np.zeros(6), "dtg": np.arange(6) + 1000, "geom": np.asarray(pts, float)}
    tb = FeatureBatch.from_columns(sft, cols, np.arange(6)).with_visibility(["", "A", "", "B", "", ""])
    jb = JFeatureBatch.from_columns(jsft, cols, np.arange(6)).with_visibility(["", "A", "", "B", "", ""])
    got, want = tm.match("t", tb, sft), jm.match("t", jb, jsft)
    _same_matches(got, want)
    by = {s.sub_id: r.tolist() for s, r in got}
    assert by == {"box": [0, 4, 5], "cql": [5], "dw": [4, 5], "vis": [0, 1, 4, 5]}
    assert tm.launches == jm.launches == 1
    assert str(tm.layout_device("t")) == "cpu"
    for r in regs:
        r.close()


@pytest.mark.parametrize("seed", range(10))
def test_seeded_random_subscriptions_match_as_the_reference(tmp_path, seed, engine):
    """200 subscriptions (random ECQL trees, bboxes, dwithins, auths) x 20
    append batches of labeled rows: the port's matches equal the JAX
    package's, one fused join a batch."""
    docs = _docs(100 + seed, 200)
    tm, jm, sft, jsft, regs = _matchers(tmp_path, docs)
    rng = np.random.default_rng(seed)
    nonempty = pairs = 0
    for b in range(20):
        n = int(rng.integers(0, 60))
        nonempty += n > 0
        tb, jb = _batches("z3", n, seed * 100 + b, labels=bool(b % 2))
        got = tm.match("t", tb, sft)
        _same_matches(got, jm.match("t", jb, jsft))
        pairs += sum(len(r) for _, r in got)
    assert pairs > 100  # the case matches rows
    # an empty batch matches nothing and joins nothing
    assert tm.launches == jm.launches == nonempty
    for r in regs:
        r.close()


def test_one_fused_join_per_batch_regardless_of_subscriptions(tmp_path):
    t, j = _stores(tmp_path)
    tl, jl = StreamingStore(t), JStreamingStore(j)
    hubs = PubSubHub(tl), JHub(jl)
    try:
        rng = np.random.default_rng(7)
        for k in range(16):
            x, y = float(rng.uniform(-170, 150)), float(rng.uniform(-80, 60))
            for h in hubs:
                h.subscribe("t", {"bbox": [x, y, x + 15, y + 15]}, tenant=f"t{k}", auths=None)
        base = [h.matcher.launches for h in hubs]
        for b in range(5):
            cols = _cols(rng.uniform(-90, 90, size=(32, 2)))
            for lay in (tl, jl):
                lay.append("t", cols, fids=np.arange(b * 32, b * 32 + 32))
        for h, b0 in zip(hubs, base):
            assert h.matcher.launches - b0 == 5 and h.matched_records == 5
        assert hubs[0].matcher.layout_device("t").type == "cpu"
    finally:
        for h, lay in zip(hubs, (tl, jl)):
            h.close()
            lay.close()


def test_a_matcher_without_a_device_refuses_the_cpu(tmp_path, monkeypatch):
    """The matcher is an entry point: with no device it runs on ``cuda:0``,
    and without CUDA it raises rather than matching on the host; the CPU
    only when asked by name."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = SubscriptionRegistry(str(tmp_path / "p"))
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SubscriptionMatcher(reg)
        assert SubscriptionMatcher(reg, device="cpu").device == torch.device("cpu")
    finally:
        reg.close()


# -- the hub, each scenario in both packages ------------------------------------


@pytest.fixture
def hubs(tmp_path):
    t, j = _stores(tmp_path)
    tl, jl = StreamingStore(t), JStreamingStore(j)
    th, jh = PubSubHub(tl), JHub(jl)
    yield (tl, th), (jl, jh)
    for h, lay in ((th, tl), (jh, jl)):
        h.close()
        lay.close()


def _take(hub, sub_id, from_seq, want, heartbeat_s=0.05, timeout_s=15.0):
    """(seq, fids) of the first ``want`` match events from ``from_seq``."""
    out = []
    gen = hub.events("t", sub_id, from_seq, heartbeat_s)
    deadline = time.monotonic() + timeout_s
    try:
        for ev in gen:
            if ev[0] == "match":
                out.append((ev[1], ev[2].fids.tolist()))
                if len(out) >= want:
                    break
            assert time.monotonic() < deadline, f"only {len(out)}/{want} matches"
    finally:
        gen.close()
    return out


def _both(hubs, fn):
    """fn(layer, hub, package) in both packages; their results equal."""
    (tl, th), (jl, jh) = hubs
    got, want = fn(tl, th, "port"), fn(jl, jh, "jax")
    assert got == want
    return got


def test_residuals_through_the_hub_equal_the_reference(hubs):
    def run(lay, hub, _):
        ids = [hub.subscribe("t", d, tenant="a", auths=None)["id"] for d in (
            {"bbox": [0, 0, 10, 10]}, {"bbox": [0, 0, 10, 10], "cql": "val > 50"},
            {"dwithin": {"x": 0, "y": 0, "distance": 1.0}})]
        lay.append("t", _cols([[5, 5], [6, 6], [120, 40], [0.9, 0.9], [0.5, 0.0]],
                              vals=[10, 90, 90, 0, 0]), fids=np.arange(5))
        return [_take(hub, i, -1, 1) for i in ids]

    got = _both(hubs, run)
    assert [sorted(g[0][1]) for g in got] == [[0, 1, 3, 4], [1], [4]]


def test_visibility_fails_closed_as_the_reference(hubs):
    def run(lay, hub, pkg):
        a = hub.subscribe("t", {"bbox": [0, 0, 10, 10]}, tenant="a", auths=None)["id"]
        b = hub.subscribe("t", {"bbox": [0, 0, 10, 10]}, tenant="b", auths=("secret",))["id"]
        cls = FeatureBatch if pkg == "port" else JFeatureBatch
        batch = cls.from_columns(lay.store.get_schema("t"), _cols([[5, 5], [6, 6]]),
                                 fids=np.arange(2)).with_visibility(["", "secret"])
        lay.append("t", batch)
        return _take(hub, a, -1, 1), _take(hub, b, -1, 1)

    got = _both(hubs, run)
    assert got == ([(0, [0])], [(0, [0, 1])])


def test_exactly_once_resume_across_a_disconnect(hubs):
    def run(lay, hub, _):
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        lay.append("t", _cols([[5, 5]]), fids=[0])
        first = _take(hub, sub["id"], sub["cursor"], 1)
        lay.append("t", _cols([[6, 6]]), fids=[1])
        lay.append("t", _cols([[7, 7]]), fids=[2])
        return first, _take(hub, sub["id"], first[0][0], 2)

    assert _both(hubs, run) == ([(0, [0])], [(1, [1]), (2, [2])])


def test_a_slow_consumer_is_torn_down_and_replays(hubs):
    def run(lay, hub, pkg):
        po = prop_override if pkg == "port" else jprop_override
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        with po("sub.queue.events", 3):
            gen = hub.events("t", sub["id"], sub["cursor"], 0.05)
            first = next(gen)[0]
            for i in range(6):
                lay.append("t", _cols([[5, 5]]), fids=[i])
            ended = next(ev for ev in gen if ev[0] == "end")
            gen.close()
        return first, ended, [s for s, _ in _take(hub, sub["id"], sub["cursor"], 6)]

    assert _both(hubs, run) == ("heartbeat", ("end", "overflow"), list(range(6)))


def test_a_match_fault_never_unacks_the_append(hubs):
    def run(lay, hub, pkg):
        fo = failpoints.failpoint_override if pkg == "port" else jfp.failpoint_override
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        with fo("fail.sub.match", "raise:1"):
            out = lay.append("t", _cols([[5, 5]]), fids=[0])
        return out["rows"], hub.match_faults, _take(hub, sub["id"], sub["cursor"], 1)

    assert _both(hubs, run) == (1, 1, [(0, [0])])


def test_the_retention_floor_pins_then_ages_out(hubs):
    def run(lay, hub, pkg):
        po = prop_override if pkg == "port" else jprop_override
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        lay.append("t", _cols([[5, 5]]), fids=[0])
        out = [hub.retention_floor("t")]
        _take(hub, sub["id"], sub["cursor"], 1)
        out.append(hub.retention_floor("t"))
        with po("sub.retain.s", 0.05):
            time.sleep(0.12)
            out.append(hub.retention_floor("t"))
        return out

    assert _both(hubs, run) == [-1, 0, None]


def test_a_cursor_below_the_compacted_tail_is_gone(hubs, monkeypatch):
    def run(lay, hub, pkg):
        err = CursorGoneError if pkg == "port" else JCursorGone
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        for i in range(3):
            lay.append("t", _cols([[5, 5]]), fids=[i])
        monkeypatch.setattr(lay._ts("t").wal, "first_seq", lambda: 2)
        with pytest.raises(err):
            hub.events("t", sub["id"], 0, 0.05)
        gen = hub.events("t", sub["id"], 1, 0.05)
        ev = next(gen)
        gen.close()
        return ev[0], ev[1], hub.cursor_gone("t", 0), hub.cursor_gone("t", 1)

    assert _both(hubs, run) == ("match", 2, True, False)


def test_the_commit_gate_holds_then_flushes(hubs):
    def run(lay, hub, _):
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        floor = [-1]
        hub.commit_gate = lambda type_name: floor[0]
        gen = hub.events("t", sub["id"], sub["cursor"], 0.05)
        out = [next(gen)[0]]
        lay.append("t", _cols([[5, 5]]), fids=[0])
        out += [next(gen)[0], hub.stats()["commit_pending"]]
        gen2 = hub.events("t", sub["id"], -1, 0.05)  # no replay of the held seq
        out.append(next(gen2)[0])
        floor[0] = 0
        hub.commit_advanced("t")
        out += [next(gen)[:2], next(gen2)[:2], next(gen)[0], hub.stats()["commit_pending"]]
        gen.close()
        gen2.close()
        return out

    assert _both(hubs, run) == ["heartbeat", "heartbeat", 1, "heartbeat", ("match", 0),
                                ("match", 0), "heartbeat", 0]


def test_stats_and_cancel_equal_the_reference(hubs):
    def run(lay, hub, _):
        a = hub.subscribe("t", {"bbox": [0, 0, 20, 20], "cql": "val > 0"}, tenant="a", auths=("A",))
        b = hub.subscribe("t", {"dwithin": {"x": 1, "y": 1, "distance": 3}}, tenant="b", auths=None)
        lay.append("t", _cols([[5, 5], [1, 2]], vals=[1, 0]), fids=[0, 1])
        gen = hub.events("t", a["id"], a["cursor"], 0.05)
        next(gen)
        st = hub.stats()
        ok = hub.cancel(b["id"]), hub.cancel(b["id"])
        gen.close()
        st2 = hub.stats()
        for s in (st, st2):
            s["registry"]["wal"] = {k: v for k, v in s["registry"]["wal"].items() if k != "dir"}
            for d in s["subscriptions"]:
                d["id"] = d["tenant"]
        return st, ok, st2

    st, ok, st2 = _both(hubs, run)
    assert ok == (True, False) and st["connections"] == 1 and len(st2["subscriptions"]) == 1


def test_a_cancelled_stream_ends(hubs):
    def run(lay, hub, _):
        sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
        gen = hub.events("t", sub["id"], sub["cursor"], 0.05)
        first = next(gen)[0]
        hub.cancel(sub["id"])
        end = next(ev for ev in gen if ev[0] == "end")
        gen.close()
        with pytest.raises(KeyError):
            hub.events("t", sub["id"], -1, 0.05)
        return first, end

    assert _both(hubs, run) == ("heartbeat", ("end", "cancelled"))


def test_the_retention_floor_holds_a_compaction_truncation(tmp_path):
    """A live connection's watermark pins the WAL segments above it through
    a compaction, in both packages; with no subscriber the segments go.
    Each append's record outgrows a 4 KB segment in both packages' payload
    formats, so every append seals a segment of its own."""
    t, j = _stores(tmp_path)
    out = []
    rows_ = 200

    def append(lay, i):
        lay.append("t", _cols(np.full((rows_, 2), 5.0)), fids=np.arange(i * rows_, (i + 1) * rows_))

    for ds, lay_cls, hub_cls, po in ((t, StreamingStore, PubSubHub, prop_override),
                                     (j, JStreamingStore, JHub, jprop_override)):
        with po("wal.segment.bytes", 1):
            lay = lay_cls(ds)
            lay._compact_due = lambda ts: False
            hub = hub_cls(lay)
            sub = hub.subscribe("t", {"bbox": [0, 0, 20, 20]}, tenant="a", auths=None)
            gen = hub.events("t", sub["id"], sub["cursor"], 0.05)
            next(gen)  # armed, watermark -1
            for i in range(4):
                append(lay, i)
            lay.compact_now("t")
            pinned = lay._ts("t").wal.first_seq()
            gen.close()
            hub.cancel(sub["id"])
            for i in range(4, 6):
                append(lay, i)
            lay.compact_now("t")
            out.append((pinned, lay._ts("t").wal.first_seq(), lay.count("t", "INCLUDE")))
            hub.close()
            lay.close()
    assert out[0] == out[1]
    assert out[0][0] == 0 and out[0][1] == 5 and out[0][2] == 6 * rows_
