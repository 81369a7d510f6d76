"""The file-system store's pieces below the store, against the JAX
package's: the partition-file codec (``store/partfile.py``) against the
JAX package's Arrow round trip (``to_arrow``/``from_arrow``), the
partition schemes (``store/partitions.py``) and the chunk statistics
(``store/chunkstats.py``).

- Codec: every attribute type (String with nulls and non-ASCII, Integer,
  Long, Float, Double with NaN and +-inf, Boolean, Bytes with nulls, Date,
  Polygon as WKT, Point), string fids and the visibility column; one
  block (v1), 16- and 128-row chunk blocks (v2) and an empty partition:
  the decoded batch equals the JAX package's round trip of the same rows.
  A ``chunk_sel`` read returns exactly those chunks' rows and reads only
  their bytes (plus the header). Checksums: a flipped byte fails
  ``verify_bytes``, as in the JAX package.
- Schemes: per-row leaves and the flush's leaf groups equal the JAX
  package's ``leaves`` and its ``sorted(set(...))`` / ``np.nonzero``
  grouping, for every scheme kind and composites; ``scheme_for`` refuses
  what the JAX package refuses.
- Chunk statistics: ``build_chunk_set`` and its JSON round trip,
  ``classify``, ``chunks_overlapping`` and ``prorate_coarse`` equal.
Tolerance: equal.
"""

import json

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.store import chunkstats as jcks
from geomesa_tpu.store import fs as jfs
from geomesa_tpu.store import partitions as jparts
from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.store import chunkstats as cks
from geomesa_tpu_torch.store import partfile
from geomesa_tpu_torch.store import partitions as parts

SPEC = ("name:String,i:Int,l:Long,f:Float,d:Double,b:Boolean,u:Bytes,dtg:Date,"
        "shape:Polygon,*geom:Point:srid=4326")


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n) * 1e3)
    d[: min(n, 3)] = [np.inf, -np.inf, np.nan][: min(n, 3)]
    c = np.round(rng.uniform(-60, 60, (n, 2)) * 64) / 64
    return {
        "name": np.array(["a", "ümlaut", None, "x,y", ""], object)[rng.integers(0, 5, n)],
        "i": rng.integers(-2**31, 2**31 - 1, n),
        "l": rng.integers(-2**62, 2**62, n),
        "f": rng.normal(size=n).astype(np.float32),
        "d": d,
        "b": rng.random(n) < 0.5,
        "u": np.array([b"\x00\x01", None, b""], object)[rng.integers(0, 3, n)],
        "dtg": rng.integers(-10**11, 10**12, n),
        "shape": [f"POLYGON(({a} {b}, {a + 0.125} {b}, {a} {b + 0.1}, {a} {b}))" for a, b in c],
        "geom": rng.uniform([-180, -90], [180, 90], (n, 2)),
        VIS_COLUMN: np.array(["", "A&B", "(A|B)&C"], object)[rng.integers(0, 3, n)],
    }


def _batches(n, seed, string_fids=True):
    cols = _cols(n, seed)
    fids = np.array([f"fid-{i}" for i in range(n)], object) if string_fids else None
    return (FeatureBatch.from_columns(SimpleFeatureType.create("t", SPEC), cols, fids),
            JBatch.from_columns(JSFT.create("t", SPEC), cols, fids))


def _block_sizes(data):
    return [int(c["length"]) for c in partfile.parse_header(data)[0]["chunks"]]


def _same_batch(got, want):
    assert [str(f) for f in got.fids] == [str(f) for f in want.fids]
    assert got.fids.dtype == want.fids.dtype
    assert sorted(got.columns) == sorted(want.columns)
    for k, v in want.columns.items():
        g = got.columns[k]
        if k == "shape":
            from geomesa_tpu.geom.wkt import to_wkt as jwkt
            from geomesa_tpu_torch.geom import to_wkt

            assert [to_wkt(a) for a in g] == [jwkt(b) for b in v]
        elif v.dtype == object:
            assert list(g) == list(v), k
        else:
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("chunk_rows", [None, 16, 128], ids=["v1", "c16", "c128"])
@pytest.mark.parametrize("string_fids", [True, False], ids=["str-fids", "int-fids"])
def test_codec_round_trip_equals_the_arrow_round_trip(chunk_rows, string_fids):
    batch, jbatch = _batches(700, seed=1, string_fids=string_fids)
    data, blocks = partfile.encode_rows(batch, 100, 650, chunk_rows)
    want = JBatch.from_arrow(jbatch.take(np.arange(100, 650)).to_arrow(), jbatch.sft)
    got = partfile.decode_table(partfile.parse_table(data), batch.sft)
    _same_batch(got, want)
    assert len(blocks) == (1 if chunk_rows is None else -(-550 // chunk_rows))
    assert blocks == _block_sizes(data)


def test_empty_partitions_round_trip(tmp_path):
    batch, jbatch = _batches(10, seed=2)
    for cr in (None, 16):
        data, blocks = partfile.encode_rows(batch, 4, 4, cr)
        got = partfile.decode_table(partfile.parse_table(data), batch.sft)
        want = JBatch.from_arrow(jbatch.take(np.array([], dtype=np.int64)).to_arrow(), jbatch.sft)
        assert len(got) == len(want) == 0 and len(blocks) == 1
        assert sorted(got.columns) == sorted(want.columns)


def test_chunk_selective_reads_return_exactly_those_chunks(tmp_path):
    batch, _ = _batches(1000, seed=3)
    data, blocks = partfile.encode_rows(batch, 0, 1000, 64)
    path = tmp_path / "part.gmcol"
    path.write_bytes(bytes(data))
    assert blocks == _block_sizes(data) and len(blocks) == 16
    for sel in ([0], [3, 7, 15], list(range(16)), []):
        raw = partfile.read_table(str(path), sel)
        got = partfile.decode_table(raw, batch.sft)
        rows = np.concatenate([np.arange(i * 64, min(i * 64 + 64, 1000)) for i in sel]) \
            if sel else np.array([], dtype=np.int64)
        assert list(got.fids) == list(batch.fids[rows])
        np.testing.assert_array_equal(got.columns["l"], batch.columns["l"][rows])
        header = len(partfile.MAGIC) + 8 + len(
            bytes(data[len(partfile.MAGIC) + 8: len(partfile.MAGIC) + 8
                       + int.from_bytes(bytes(data[8:16]), "little")]))
        assert raw.nbytes == header + sum(blocks[i] for i in sel)
        via_bytes = partfile.decode_table(partfile.parse_table(data, sel), batch.sft)
        assert list(via_bytes.fids) == list(got.fids)
    with pytest.raises(ValueError, match="outside"):
        partfile.read_table(str(path), [16])


def test_checksums_equal_the_reference():
    batch, _ = _batches(300, seed=4)
    data, _ = partfile.encode_rows(batch, 0, 300, 16)
    algo, value = partfile.checksum_bytes(data)
    assert (algo, value) == jfs.checksum_bytes(bytes(data))
    rec = {"algo": algo, "value": value, "length": len(data)}
    assert partfile.verify_bytes(data, rec) is None is jfs.verify_bytes(bytes(data), rec)
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0x01
    assert partfile.verify_bytes(bad, rec) == jfs.verify_bytes(bytes(bad), rec) is not None
    assert partfile.verify_bytes(data[:-1], rec) == jfs.verify_bytes(bytes(data[:-1]), rec)
    assert partfile.verify_bytes(data, {"algo": "md5", "length": len(data)}) is None
    with pytest.raises(ValueError, match="magic"):
        partfile.parse_table(b"PAR1" + bytes(data[4:]))


SCHEME_SPECS = ["daily", "weekly", "hourly", "monthly", "yearly", "minute", "datetime",
                "z2-2bit", "z2-8bits", "xz2-4bit", "xz3-4bits", "attribute:name", "attribute:count",
                "daily,z2-2bit", "daily:z2-2bits", "weekly,attribute:name", "xz3-2bit:attr:name"]


@pytest.mark.parametrize("spec", SCHEME_SPECS)
def test_scheme_leaves_and_groups_equal_the_reference(spec):
    rng = np.random.default_rng(5)
    n = 2000
    sft = "name:String,count:Int,dtg:Date,*geom:Point:srid=4326"
    cols = {"name": np.array(["a b", "b", "c/d", None, "..x"], object)[rng.integers(0, 5, n)],
            "count": rng.integers(0, 6, n),
            "dtg": 1_577_836_800_000 + rng.integers(-10 * 86_400_000, 60 * 86_400_000, n),
            "geom": rng.uniform([-180, -90], [180, 90], (n, 2))}
    b = FeatureBatch.from_columns(SimpleFeatureType.create("t", sft), cols)
    jb = JBatch.from_columns(JSFT.create("t", sft), cols)
    scheme, jscheme = parts.scheme_for(spec), jparts.scheme_for(spec)
    assert scheme.spec == jscheme.spec and scheme.depth == jscheme.depth
    want = jscheme.leaves(jb)
    assert list(scheme.leaves(b)) == list(want)
    groups = scheme.leaf_groups(b)
    assert [leaf for leaf, _ in groups] == sorted(set(want))
    for leaf, idx in groups:
        np.testing.assert_array_equal(idx, np.nonzero(want == leaf)[0])


@pytest.mark.parametrize("spec", ["", "z2-3bit", "z2-40bit", "xz2-13bit", "fortnightly", "attribute"])
def test_scheme_for_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError):
        jparts.scheme_for(spec)
    with pytest.raises(ValueError):
        parts.scheme_for(spec)


def test_part_file_names_follow_the_reference():
    assert parts.part_file_name(7, "gmcol", "ab12cd34") == "part-ab12cd34-00007.gmcol"
    assert parts.part_file_name(7, "gmcol") == jparts.part_file_name(7, "gmcol") == "part-00007.gmcol"


def test_chunk_statistics_equal_the_reference():
    from geomesa_tpu.geom import Envelope as JEnvelope
    from geomesa_tpu.index.build import build_index as jbuild
    from geomesa_tpu.index.keyspaces import keyspace_for as jks
    from geomesa_tpu.query.plan import as_query as jas_query
    from geomesa_tpu.query.plan import plan_query as jplan
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.index.build import build_index
    from geomesa_tpu_torch.index.keyspaces import keyspace_for
    from geomesa_tpu_torch.query.plan import as_query, plan_query

    batch, jbatch = _batches(3000, seed=6, string_fids=False)
    batch.columns["geom"][5] = np.nan  # a NaN row poisons its chunk's bbox
    jbatch.columns["geom"][5] = np.nan
    built = build_index(keyspace_for(batch.sft, "z3"), batch, 1024)
    jbuilt = jbuild(jks(jbatch.sft, "z3"), jbatch, 1024)
    f = "BBOX(geom, -50, -30, 70, 45) AND dtg DURING 2001-01-01T00:00:00Z/2020-01-01T00:00:00Z"
    plan = plan_query(batch.sft, {"z3": keyspace_for(batch.sft, "z3")}, as_query(f))
    jp = jplan(jbatch.sft, {"z3": jks(jbatch.sft, "z3")}, jas_query(f))
    for p, jp_ in zip(built.partitions, jbuilt.partitions):
        cs = cks.build_chunk_set(built.keyspace, built.batch, built.keys, p.start, p.stop, 100, 16)
        jcs = jcks.build_chunk_set(jbuilt.keyspace, jbuilt.batch, jbuilt.keys, jp_.start, jp_.stop, 100, 16)
        # as the manifest writes them (NaN partials compare as "NaN")
        got = json.dumps(cks.chunkset_to_json(cs), sort_keys=True)
        assert got == json.dumps(jcks.chunkset_to_json(jcs), sort_keys=True)
        back = cks.chunkset_from_json(json.loads(got))
        assert json.dumps(cks.chunkset_to_json(back), sort_keys=True) == got
        np.testing.assert_array_equal(cks.classify(cs, *plan.agg_bounds), jcks.classify(jcs, *jp.agg_bounds))
        np.testing.assert_array_equal(cks.chunks_overlapping(cs, plan.ranges),
                                      jcks.chunks_overlapping(jcs, jp.ranges))
        coarse = np.zeros((16, 16))
        for c, n in zip(cs.cells, cs.cell_counts):
            np.add.at(coarse.reshape(-1), c, n)
        np.testing.assert_array_equal(
            cks.prorate_coarse(coarse, 16, Envelope(-50.0, -30.0, 70.0, 45.0), 24, 12),
            jcks.prorate_coarse(coarse, 16, JEnvelope(-50.0, -30.0, 70.0, 45.0), 24, 12))
