"""Port parity for the file-system store's maintenance operations:
``delete``, ``age_off``, ``update_user_data``, ``compact``, ``reindex``
and ``repartition`` go to a ``geomesa_tpu_torch`` and a ``geomesa_tpu``
``FileSystemDataStore`` (the port on ``device="cpu"``), v1 and v2, with
and without a scheme, 64-row partitions and 16-row chunks. After each,
compared equal: the manifests (partitions, chunk statistics, stats,
interval, primary, spec), a full scan and a bbox+during query (fids in
order, columns, ``scanned``, ``total``, the index), ``store_stats``'s
per-type rows and partitions, and what the operation returned. Then
``query_partitions`` (one filtered batch per surviving partition) against
the JAX package's, batch by batch.
"""

import pytest
from _torch_fs_cases import DAY, T0, props, rows, same, same_manifest, written

QUERIES = ["INCLUDE", "BBOX(geom, -40.5, -20.25, 60.75, 45.5) AND "
           "dtg DURING 2020-01-02T00:00:00Z/2020-01-04T12:00:00Z"]
CASES = [(None, 1), (None, 2), ("daily", 2), ("z2-2bit", 1)]


def _agree(tds, jds):
    same_manifest(tds, jds)
    for f in QUERIES:
        same(tds.query("t", f), jds.query("t", f))
    got, want = tds.store_stats()["types"]["t"], jds.store_stats()["types"]["t"]
    for k in ("rows", "partitions", "format", "chunked_partitions", "chunks", "chunk_rows_covered"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("scheme,fmt", CASES, ids=[f"{s}-v{f}" for s, f in CASES])
def test_maintenance_equals_the_reference(tmp_path, scheme, fmt):
    with props(store_format_version=fmt, store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", scheme, seed=7 + fmt)
        _agree(tds, jds)
        drop = list(range(0, 400, 3)) + [50_010, 99_999]
        assert tds.delete("t", drop) == jds.delete("t", drop) > 0
        _agree(tds, jds)
        cut = T0 + 2 * DAY
        assert tds.age_off("t", cut) == jds.age_off("t", cut) > 0
        _agree(tds, jds)
        for ds in (tds, jds):
            ds.update_user_data("t", {"keywords": "a,b", "geomesa.z3.interval": None})
        _agree(tds, jds)
        assert tds.get_schema("t").user_data == jds.get_schema("t").user_data
        more = rows("z3", 150, seed=31)
        for ds in (tds, jds):
            ds.write("t", more)
            ds.compact("t")
        _agree(tds, jds)
        for ds in (tds, jds):
            ds.reindex("t", "z2")
        _agree(tds, jds)
        for ds in (tds, jds):
            ds.reindex("t", "z3")
            ds.repartition("t", "daily:z2-2bit" if scheme is None else None)
        _agree(tds, jds)
        with pytest.raises(ValueError):
            tds.repartition("t", "nonsense")
        with pytest.raises(Exception):
            jds.repartition("t", "nonsense")


def test_empty_and_unflushed_types_equal_the_reference(tmp_path):
    """A type with no rows: an empty query, an empty manifest, a rebuild of
    nothing; pending rows flush on the first query."""
    with props(store_chunk_rows=16):
        from _torch_fs_cases import pair

        tds, jds = pair(str(tmp_path), "z3")
        for f in QUERIES:
            same(tds.query("t", f), jds.query("t", f))
        for ds in (tds, jds):
            ds.compact("t")
        same_manifest(tds, jds)
        cols = rows("z3", 90, seed=3)
        for ds in (tds, jds):
            ds.write("t", cols)
        same(tds.query("t", QUERIES[1]), jds.query("t", QUERIES[1]))
        same_manifest(tds, jds)
        assert tds.delete("t", []) == jds.delete("t", []) == 0


@pytest.mark.parametrize("scheme", [None, "daily:z2-2bit"], ids=["none", "daily-z2"])
def test_query_partitions_equal_the_reference(tmp_path, scheme):
    from geomesa_tpu.query.plan import Query as JQuery
    from geomesa_tpu_torch.query.plan import Query

    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", scheme, seed=9, labels=True)
    for f in QUERIES:
        for auths in (None, ("A", "B")):
            got = list(tds.query_partitions("t", Query(filter=f, hints={"auths": auths})))
            want = list(jds.query_partitions("t", JQuery(filter=f, hints={"auths": auths})))
            assert [list(b.fids) for b in got] == [list(b.fids) for b in want]
            assert [sorted(b.columns) for b in got] == [sorted(b.columns) for b in want]
