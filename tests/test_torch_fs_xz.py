"""Port parity for the file-system store on non-point schemas: xz2 and
xz3 polygons under the partition schemes none, ``daily`` (xz3),
``xz2-4bit`` and ``attribute:name``, formats v1 and v2 (no scheme under
both, each scheme under one), the random ECQL
trees and options of ``test_torch_fs_store.py`` (no BEFORE/AFTER on xz3:
the JAX package's plan of an open interval there does not return,
ROADMAP section 3), compared the same way. Polygon corners and query
constants lie on a 1/64-degree grid; the partition files carry the
polygons as WKT at the JAX package's 10 significant digits.
"""

import pytest
from _torch_fs_cases import check_case

CASES = [
    ("xz2", None, 1), ("xz2", None, 2), ("xz2", "xz2-4bit", 2), ("xz2", "attribute:name", 1),
    ("xz3", None, 1), ("xz3", None, 2), ("xz3", "daily", 2), ("xz3", "xz2-4bit", 1),
    ("xz3", "attribute:name", 2),
]


@pytest.mark.parametrize("kind,scheme,fmt", CASES, ids=[f"{k}-{s}-v{f}" for k, s, f in CASES])
def test_xz_queries_and_manifests_equal_the_reference(tmp_path, kind, scheme, fmt):
    check_case(tmp_path, kind, scheme, fmt, 100 + CASES.index((kind, scheme, fmt)))
