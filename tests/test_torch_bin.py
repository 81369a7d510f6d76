"""Port parity for BIN output: ``geomesa_tpu_torch``'s
``process/binexport.py``, ``DeviceIndex.bin_export`` (the host twin),
``DeviceIndex.bin_rider`` (the device pack, torch ops on CPU tensors here)
and ``results/binrider.py`` ``resident_bin`` against ``geomesa_tpu``'s, on
the same seeded rows, byte for byte.

The port's vectorized ``_track_hash`` and ``_label_pack`` (one hash per
distinct value) are held against the reference's per-row loops on ints,
negatives, floats, non-ASCII strings and labels longer than 8 bytes. The
staged generation: the lane matrix is rebuilt after every mutation of a
streaming index and reused between them.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.conf import prop_override as jprop
from geomesa_tpu.device_cache import DeviceIndex as JIndex
from geomesa_tpu.device_cache import StreamingDeviceIndex as JStream
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.process import binexport as jbin
from geomesa_tpu.results.binrider import resident_bin as jresident_bin
from geomesa_tpu.store.direct import BatchStore as JStore
from geomesa_tpu_torch import metrics
from geomesa_tpu_torch.conf import prop_override
from geomesa_tpu_torch.device_cache import DeviceIndex, StreamingDeviceIndex
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.ops.binpack import bin_count, bin_pack
from geomesa_tpu_torch.process import binexport as tbin
from geomesa_tpu_torch.results.binrider import bin_engine, resident_bin
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

T0 = 1_577_836_800_000
DAY = 86_400_000
SPEC = "mmsi:Int,vessel_type:String,name:String,dtg:Date,*geom:Point:srid=4326"
NAMES = ["Nordic Star", "Zürich", "MÆRSK KOBE", "长江号", "a", "", "bravo-bravo-bravo"]
QUERIES = ["INCLUDE", "BBOX(geom, -5, -5, 5, 5)",
           "BBOX(geom, -8, -2, 3, 9) AND dtg DURING 2020-01-02T00:00:00Z/2020-01-05T00:00:00Z",
           "mmsi > 300 AND BBOX(geom, -9, -9, 0, 0)", "BBOX(geom, 50, 50, 51, 51)"]


def _cols(n, seed, labels=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (n, 2)).astype(np.float32).astype(np.float64)
    cols = {"mmsi": rng.integers(-5, 1000, n),
            "vessel_type": np.array(rng.choice(["30", "cargo", "tanker ship", "ƒishing"], n),
                                    dtype=object),
            "name": np.array(rng.choice(NAMES, n), dtype=object),
            "dtg": T0 + rng.integers(-DAY, 10 * DAY, n), "geom": xy}
    if labels is not None:
        cols[VIS_COLUMN] = np.array(rng.choice(labels, n), dtype=object)
    return cols


def _pair(cols, spec=SPEC, **kw):
    jdi = JIndex(JStore(JBatch.from_columns(JSFT.create("v", spec), cols)), "v", **kw)
    tdi = DeviceIndex(BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("v", spec),
                                                           cols)), "v", device="cpu", **kw)
    return jdi, tdi


@pytest.fixture(scope="module")
def pair():
    return _pair(_cols(4000, 1), z_planes=True)


@pytest.mark.parametrize("values", [
    np.array([1, -5, 2**40, -(2**35) - 3, 0]),
    np.array([7, 7, 300], np.int32),
    np.array(["abc", "Zürich", "ß", "abc", "", "长江"], dtype=object),
    np.array(["x", "yy", "x", "a very long label indeed"]),
    np.array([0.1, -0.0, 0.0, np.nan, 0.1, 1e20], np.float32),
    np.array([0.1, -0.0, 2.5], np.float64),
    np.array([True, False, True]),
    np.array(["a very long label", None, 3, "é€", 2.5, "a very long label"], dtype=object),
    np.array([], dtype=object),
], ids=["int64", "int32", "unicode", "str", "float32", "float64", "bool", "mixed", "empty"])
def test_track_hash_and_label_pack_equal_the_reference(values):
    np.testing.assert_array_equal(tbin._track_hash(values), jbin._track_hash(values))
    np.testing.assert_array_equal(tbin._label_pack(values), jbin._label_pack(values))


@pytest.mark.parametrize("label", [None, "name"])
@pytest.mark.parametrize("sort", [False, True])
def test_encode_bin_equals_the_reference(label, sort):
    cols = _cols(500, 2)
    jb = JBatch.from_columns(JSFT.create("v", SPEC), cols)
    tb = FeatureBatch.from_columns(SimpleFeatureType.create("v", SPEC), cols)
    for track in ("mmsi", "name"):
        want = jbin.encode_bin(jb, track, label_attr=label, sort=sort)
        got = tbin.encode_bin(tb, track, label_attr=label, sort=sort)
        assert got == want
        np.testing.assert_array_equal(tbin.decode_bin(got, labels=label is not None),
                                      jbin.decode_bin(want, labels=label is not None))


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("track,label", [("mmsi", None), ("name", "vessel_type"),
                                         ("vessel_type", "name")])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("loose", [False, True])
def test_bin_export_and_rider_equal_the_reference(pair, query, track, label, sort, loose):
    jdi, tdi = pair
    kw = dict(label_attr=label, sort=sort, loose=loose)
    want = jdi.bin_export(query, track, **kw)
    assert tdi.bin_export(query, track, **kw) == want
    assert jdi.bin_rider(query, track, **kw) == want
    assert tdi.bin_rider(query, track, **kw) == want
    assert len(want) % (24 if label else 16) == 0


def test_rider_counts_its_packs(pair):
    _, tdi = pair
    before = metrics.results_bin_device_launches.value()
    for q in QUERIES:
        tdi.bin_rider(q, "mmsi")
    empty = sum(tdi.count(q) == 0 for q in QUERIES)
    assert metrics.results_bin_device_launches.value() - before == len(QUERIES) - empty


def test_resident_bin_engines(pair):
    jdi, tdi = pair
    assert bin_engine(tdi) == "host"  # auto: an index on the CPU takes the twin
    q = QUERIES[2]
    for eng in ("auto", "host", "device"):
        with jprop("results.bin.engine", eng), prop_override("results.bin.engine", eng):
            assert bin_engine(tdi) == ("host" if eng == "auto" else eng)
            want = jresident_bin(jdi, q, "mmsi", label_attr="name", sort=True)
            assert resident_bin(tdi, q, "mmsi", label_attr="name", sort=True) == want


def test_labeled_index_takes_the_twin():
    cols = _cols(3000, 3, labels=["", "A", "B", "A&B"])
    jdi, tdi = _pair(cols)
    for auths in (None, ("A",), ("A", "B")):
        for q in QUERIES[:3]:
            assert tdi.bin_rider(q, "mmsi", auths=auths) is None
            assert jdi.bin_rider(q, "mmsi", auths=auths) is None
            want = jdi.bin_export(q, "mmsi", auths=auths)
            assert tdi.bin_export(q, "mmsi", auths=auths) == want
            assert resident_bin(tdi, q, "mmsi", auths=auths) == want
    with prop_override("results.bin.engine", "device"), jprop("results.bin.engine", "device"):
        with pytest.raises(ValueError, match="device-expressible"):
            resident_bin(tdi, QUERIES[1], "mmsi")
        with pytest.raises(ValueError, match="device-expressible"):
            jresident_bin(jdi, QUERIES[1], "mmsi")


def test_auto_engine_on_the_card_takes_the_twin_for_labeled_rows(monkeypatch):
    """``auto`` resolves to the device pack for an index on the card (here
    stood in for by patching the resolution); a labeled staging then takes
    the twin: only a pinned ``device`` raises (ROADMAP section 3)."""
    from geomesa_tpu_torch.results import binrider

    jdi, tdi = _pair(_cols(500, 12, labels=["", "A"]))
    monkeypatch.setattr(binrider, "bin_engine", lambda di: "device")
    assert binrider.resident_bin(tdi, QUERIES[1], "mmsi", auths=("A",)) == jdi.bin_export(
        QUERIES[1], "mmsi", auths=("A",))


def test_non_point_and_residual_shapes_decline():
    spec = "mmsi:Int,dtg:Date,*geom:Polygon:srid=4326"
    cols = {"mmsi": [1, 2], "dtg": [T0, T0 + 1000],
            "geom": ["POLYGON((0 0, 1 0, 1 1, 0 0))", "POLYGON((5 5, 6 5, 6 6, 5 5))"]}
    jdi, tdi = _pair(cols, spec)
    assert tdi.bin_rider("INCLUDE", "mmsi") is None
    assert jdi.bin_rider("INCLUDE", "mmsi") is None
    _, pdi = _pair(_cols(200, 4))
    residual = "TOUCHES(geom, POLYGON((0 0, 3 0, 3 3, 0 0)))"
    assert pdi.bin_rider(residual, "mmsi") is None


def test_empty_answers():
    jdi, tdi = _pair(_cols(0, 5))
    assert tdi.bin_rider("INCLUDE", "mmsi") == jdi.bin_rider("INCLUDE", "mmsi") == b""
    assert tdi.bin_export("INCLUDE", "mmsi") == jdi.bin_export("INCLUDE", "mmsi") == b""
    _, tdi = _pair(_cols(100, 6))
    assert tdi.bin_rider("BBOX(geom, 50, 50, 51, 51)", "mmsi", label_attr="name") == b""


def test_bin_pack_passes():
    rng = np.random.default_rng(7)
    lanes = torch.from_numpy(rng.integers(-2**31, 2**31, (6, 1000)).astype(np.int32))
    for mask in (rng.random(1000) < 0.3, np.zeros(1000, bool), np.ones(1000, bool)):
        m = torch.from_numpy(mask)
        assert bin_count(m) == int(mask.sum())
        np.testing.assert_array_equal(bin_pack(m, lanes), lanes.numpy()[:, mask].T)


class _JWriteStore(JStore):
    def write(self, type_name, columns, fids=None):
        self.batch = JBatch.concat([self.batch, JBatch.from_columns(self.sft, columns, fids)])


def test_streaming_rider_follows_the_staged_generation():
    cols = _cols(2000, 8)
    jb = JBatch.from_columns(JSFT.create("v", SPEC), cols)
    tb = FeatureBatch.from_columns(SimpleFeatureType.create("v", SPEC), cols)
    jdi = JStream(_JWriteStore(jb), "v", z_planes=True)
    tdi = StreamingDeviceIndex(BatchStore(tb), "v", z_planes=True, device="cpu")
    rng = np.random.default_rng(9)

    def check():
        for q in QUERIES[:4]:
            want = jdi.bin_export(q, "name", label_attr="vessel_type")
            assert tdi.bin_rider(q, "name", label_attr="vessel_type") == want
            assert tdi.bin_export(q, "name", label_attr="vessel_type") == want
            assert jdi.bin_rider(q, "name", label_attr="vessel_type") == want

    def step(fn):
        mat = next(iter(tdi._bin_lanes.values()))
        fn()
        check()
        new = next(iter(tdi._bin_lanes.values()))
        assert new is not mat
        check()
        assert next(iter(tdi._bin_lanes.values())) is new  # reused between mutations

    check()
    new = _cols(300, 10)
    fids = np.arange(5000, 5300)
    step(lambda: (jdi.append(JBatch.from_columns(jb.sft, new, fids)),
                  tdi.append(FeatureBatch.from_columns(tb.sft, new, fids))))
    gone = rng.choice(2000, 300, replace=False)
    step(lambda: (jdi.evict(gone), tdi.evict(gone)))
    moved = _cols(40, 11)
    mf = np.arange(40)
    step(lambda: (jdi.upsert(JBatch.from_columns(jb.sft, moved, mf)),
                  tdi.upsert(FeatureBatch.from_columns(tb.sft, moved, mf))))
    step(lambda: (jdi.refresh(), tdi.refresh()))
    before = jmetrics.results_bin_device_launches.value()
    jdi.clear()
    tdi.clear()
    assert tdi.bin_rider("INCLUDE", "mmsi") == jdi.bin_rider("INCLUDE", "mmsi") == b""
    assert jmetrics.results_bin_device_launches.value() == before
