"""Port parity for per-request visibility: ``geomesa_tpu_torch``'s label
grammar, ``BatchStore`` auth filtering and the resident index's label-id
plane against ``geomesa_tpu``'s, on the same labeled rows.

The JAX side is ``geomesa_tpu.security`` and a ``DeviceIndex`` staged with
key planes on the CPU; the port runs on ``device="cpu"`` (plain versions
of its kernels). For auths ``None``, ``()``, ``("A",)`` and
``("A", "B", "C")``: counts (loose and exact), masks, fid sets, density
grids and stats. Tolerance: bit-exact (unweighted grids are integer
counts; stats compare ``to_json()``).
"""

import warnings

import numpy as np
import pytest
import torch

from geomesa_tpu import security as jsec
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.query.plan import Query
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import security
from geomesa_tpu_torch.convert import planes_from_numpy
from geomesa_tpu_torch.device_cache import VIS_ID, DeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.query.plan import Query as TQuery
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

DAY = 86_400_000
T0 = 1_577_836_800_000  # 2020-01-01
SPEC = "count:Int,dtg:Date,name:String,*geom:Point:srid=4326"
LABELS = ["", "A", "B", "A&B", "A|C", "(A|B)&C"]
AUTHS = [None, (), ("A",), ("A", "B", "C")]
EXPRESSIONS = [
    "", "  ", "A", "A&B", "A|B", "A&B&C", "A|B|C", "(A|B)&C", "A&(B|C)",
    "((A))", '"A B"&C', '"x&y"|A', "a_b-c.d:e/f", "(A&B)|(C&D)",
    # errors
    "A&B|C", "(A&B", "A&B)", '"unterminated', "A&", "&A", "A!B", "()",
]
AUTH_SETS = [(), ("A",), ("B",), ("A", "B"), ("C",), ("A", "C"), ("A B", "C"),
             ("x&y",), ("a_b-c.d:e/f",), ("A", "B", "C", "D")]


def _outcome(mod, expr, auths):
    try:
        node = mod.parse_visibility(expr)
    except mod.VisibilityParseError as e:
        return "error", str(e)
    return "ok", node is None or node.evaluate(frozenset(auths))


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_parse_and_evaluate_match(expr):
    for auths in AUTH_SETS:
        assert _outcome(security, expr, auths) == _outcome(jsec, expr, auths)
    labels = np.array([expr, None, "A"], dtype=object)
    for auths in AUTH_SETS[:4]:
        try:
            want = jsec.VisibilityEvaluator(auths).mask(labels)
        except jsec.VisibilityParseError:
            with pytest.raises(security.VisibilityParseError):
                security.VisibilityEvaluator(auths).mask(labels)
            continue
        np.testing.assert_array_equal(security.VisibilityEvaluator(auths).mask(labels), want)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-60, -40], [60, 40], (n, 2)).astype(np.float32).astype(np.float64)
    return {
        "count": rng.integers(0, 1000, n),
        "dtg": rng.integers(T0, T0 + 60 * DAY, n),
        "name": np.array(["a", "b", "c"] * (n // 3) + ["a"] * (n % 3), dtype=object),
        "geom": xy,
        VIS_COLUMN: rng.choice(LABELS, n),
    }


def _pair(cols, z_planes=True):
    from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

    from geomesa_tpu_torch.features.sft import SimpleFeatureType

    jsft, sft = JSFT.create("t", SPEC), SimpleFeatureType.create("t", SPEC)
    jstore = JStore(JBatch.from_columns(jsft, cols))
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    jdi = JIndex(jstore, "t", z_planes=z_planes)
    tdi = DeviceIndex(store, "t", z_planes=z_planes, device="cpu")
    return jdi, tdi, jstore, store


@pytest.fixture(scope="module")
def labeled():
    return _pair(_columns(4001, seed=5))


QUERIES = [
    "BBOX(geom, -30, -20, 40, 30) AND dtg DURING 2020-01-05T00:00:00Z/2020-02-10T00:00:00Z",
    "BBOX(geom, -30, -20, 40, 30)",
    "INCLUDE",
    "BBOX(geom, -30, -20, 40, 30) AND name LIKE 'a%'",
]


def _same_answers(jdi, tdi, ecql, auths):
    for loose in (False, True):
        assert tdi.count(ecql, loose=loose, auths=auths) == jdi.count(ecql, loose=loose, auths=auths)
        np.testing.assert_array_equal(
            tdi.mask(ecql, loose=loose, auths=auths), jdi.mask(ecql, loose=loose, auths=auths)
        )
        np.testing.assert_array_equal(
            np.sort(tdi.query(ecql, loose=loose, auths=auths).fids),
            np.sort(jdi.query(ecql, loose=loose, auths=auths).fids),
        )


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
@pytest.mark.parametrize("ecql", QUERIES, ids=lambda s: s[:30])
def test_labeled_counts_masks_and_fids_match(labeled, ecql, auths):
    jdi, tdi, _, _ = labeled
    _same_answers(jdi, tdi, ecql, auths)


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
def test_labeled_density_and_stats_match(labeled, auths):
    jdi, tdi, _, _ = labeled
    env = (-64.0, -32.0, 64.0, 32.0)
    spec = 'Count();MinMax("count");MinMax("dtg");Histogram("count",20,0,1000)'
    for ecql, loose in ((QUERIES[0], False), (QUERIES[0], True), ("INCLUDE", None)):
        want = jdi.density(ecql, JEnvelope(*env), 64, 32, loose=loose, auths=auths)
        got = tdi.density(ecql, Envelope(*env), 64, 32, loose=loose, auths=auths)
        np.testing.assert_array_equal(got, want)
        assert (tdi.stats(ecql, spec, loose=loose, auths=auths).to_json()
                == jdi.stats(ecql, spec, loose=loose, auths=auths).to_json())
    none = tdi.count("INCLUDE", auths=auths)
    assert none == int(np.sum(security.VisibilityEvaluator(auths or ()).mask(
        tdi._host_batch.visibilities)))


def test_label_ids_and_plane_match(labeled):
    jdi, tdi, _, _ = labeled
    assert tdi._vis_vocab == jdi._vis_vocab
    np.testing.assert_array_equal(tdi._cols[VIS_ID].numpy(), np.asarray(jdi._cols[VIS_ID]))
    for auths in AUTHS:
        np.testing.assert_array_equal(
            tdi._auth_table(auths)[0], np.asarray(jdi._auth_table(auths))
        )


@pytest.mark.parametrize("auths", AUTHS, ids=repr)
def test_batch_store_query_with_auths(labeled, auths):
    _, _, jstore, store = labeled
    want = jstore.query("t", Query(hints={"auths": auths})).batch
    got = store.query("t", TQuery(hints={"auths": auths})).batch
    np.testing.assert_array_equal(got.fids, want.fids)
    raw = store.query("t", TQuery(hints={"auths": auths, "raw_visibility": True})).batch
    assert len(raw) == len(store.batch)


def test_unlabeled_index_stages_no_plane():
    cols = _columns(300, seed=6)
    cols[VIS_COLUMN] = np.array([""] * 300, dtype=object)
    jdi, tdi, _, _ = _pair(cols)
    assert VIS_ID not in tdi._cols and VIS_ID not in jdi._cols
    assert tdi.count(QUERIES[1], auths=None) == jdi.count(QUERIES[1], auths=None)


def test_vocabulary_overflow(monkeypatch):
    monkeypatch.setattr(JIndex, "VIS_VOCAB_MAX", 3)
    monkeypatch.setattr(DeviceIndex, "VIS_VOCAB_MAX", 3)
    cols = _columns(1500, seed=7)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        from geomesa_tpu.features.sft import SimpleFeatureType as JSFT

        jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("t", SPEC), cols)), "t", z_planes=True)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        from geomesa_tpu_torch.features.sft import SimpleFeatureType

        tdi = DeviceIndex(
            BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("t", SPEC), cols)),
            "t", z_planes=True, device="cpu",
        )
    jmsg = [str(w.message) for w in jw if issubclass(w.category, RuntimeWarning)]
    tmsg = [str(w.message) for w in tw if issubclass(w.category, RuntimeWarning)]
    assert jmsg and tmsg == jmsg
    assert len(tdi) == len(jdi) == int(np.sum(cols[VIS_COLUMN] == ""))
    assert VIS_ID not in tdi._cols
    for auths in (None, ("A", "B", "C")):
        _same_answers(jdi, tdi, QUERIES[0], auths)


def test_index_from_jax_planes_answers_identically(labeled):
    jdi, _, _, store = labeled
    planes = planes_from_numpy({k: np.asarray(v) for k, v in jdi._cols.items()}, "cpu")
    tdi = DeviceIndex.from_planes(
        store.sft, store.batch, planes, jdi._bt_base, jdi._bin_range,
        device="cpu", vis_vocab=jdi._vis_vocab,
    )
    for auths in AUTHS:
        for ecql in QUERIES[:2]:
            _same_answers(jdi, tdi, ecql, auths)
    with pytest.raises(ValueError, match="vis_vocab"):
        DeviceIndex.from_planes(store.sft, store.batch, planes, jdi._bt_base,
                                jdi._bin_range, device="cpu")
