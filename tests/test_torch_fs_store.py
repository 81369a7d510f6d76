"""Port parity for the file-system store on point schemas:
``geomesa_tpu_torch``'s ``FileSystemDataStore`` (on ``device="cpu"``,
where the filter-scan wrapper runs its plain version) against
``geomesa_tpu``'s, in-process under ``tmp_path``.

The same two writes and flushes go to a store of each package: z3 and z2
points under the partition schemes none, ``daily``, ``z2-2bit``,
``daily,z2-2bit``, ``xz2-4bit`` and ``attribute:name`` where the schema
takes them, manifest formats v1 and v2 (each scheme under one of them;
no scheme and ``daily,z2-2bit`` under both), 64-row partitions and 16-row
chunks, a third of the cases with labeled rows. Then random ECQL trees
(BBOX, INTERSECTS, DURING, BEFORE/AFTER, compares, BETWEEN, IN, LIKE, IS
NULL, INCLUDE/EXCLUDE under AND/OR/NOT) with auths, ``sort_by``,
``max_features`` and ``properties``. Compared, equal: fids in order,
columns, ``scanned``, ``total``, the index chosen, ``count``, ``explain``;
the manifests' partitions (pid, leaf, key bounds, count, bbox, time
range), ``chunkset_to_json`` (the chunk blocks' byte sizes aside: the
files' formats differ by design, ROADMAP section 3) and the stats JSON.
The xz schemas are ``test_torch_fs_xz.py``'s; the pushdowns
``test_torch_fs_pushdown.py``'s.
"""

import pytest
from _torch_fs_cases import check_case

# every scheme under one format, no scheme and the composite under both
CASES = [
    ("z3", None, 1), ("z3", None, 2), ("z3", "daily:z2-2bit", 1), ("z3", "daily:z2-2bit", 2),
    ("z3", "daily", 1), ("z3", "z2-2bit", 2), ("z3", "xz2-4bit", 1), ("z3", "attribute:name", 2),
    ("z2", None, 1), ("z2", None, 2), ("z2", "z2-2bit", 1), ("z2", "xz2-4bit", 2),
    ("z2", "attribute:name", 1),
]


@pytest.mark.parametrize("kind,scheme,fmt", CASES, ids=[f"{k}-{s}-v{f}" for k, s, f in CASES])
def test_queries_and_manifests_equal_the_reference(tmp_path, kind, scheme, fmt):
    check_case(tmp_path, kind, scheme, fmt, CASES.index((kind, scheme, fmt)))
