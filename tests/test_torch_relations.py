"""Port parity for the host geometry predicates and the DE-9IM relations:
``geomesa_tpu_torch.geom.predicates`` against ``geomesa_tpu.geom.predicates``
on the adversarial pairs of ``tests/test_geom_relations.py`` (shared edges
and vertices, holes, collinear overlaps, point / line / area in every
order) and on random lattice pairs, and ``evaluate_host`` with the
CROSSES / TOUCHES / OVERLAPS / EQUALS / RELATE predicates on point and
polygon data against the counterpart's. Every answer must be equal.
"""

import numpy as np
import pytest

from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.filter.compile import evaluate_host as jevaluate
from geomesa_tpu.filter.ecql import parse_ecql as jparse
from geomesa_tpu.geom import base as jb
from geomesa_tpu.geom import predicates as jp
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.compile import evaluate_host
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.geom import base as tb
from geomesa_tpu_torch.geom import predicates as tp
from geomesa_tpu_torch.geom import parse_wkt


def _both(make):
    """(port geometry, counterpart geometry) made by one function over each base module."""
    return make(tb), make(jb)


def sq(m, x0, y0, x1, y1, holes=()):
    return m.Polygon([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]], tuple(holes))


def line(m, *pts):
    return m.LineString(np.array(pts, dtype=float))


# the constructed cases of tests/test_geom_relations.py, every kind in play
CASES = {
    "A": lambda m: sq(m, 0, 0, 4, 4),
    "B_overlaps": lambda m: sq(m, 2, 2, 6, 6),
    "C_shared_edge": lambda m: sq(m, 4, 0, 8, 4),
    "corner": lambda m: sq(m, 4, 4, 6, 6),
    "D_inside": lambda m: sq(m, 1, 1, 2, 2),
    "E_disjoint": lambda m: sq(m, 10, 10, 12, 12),
    "holed": lambda m: sq(m, 0, 0, 10, 10, holes=[[[3, 3], [7, 3], [7, 7], [3, 7], [3, 3]]]),
    "in_hole": lambda m: sq(m, 4, 4, 6, 6),
    "hole_edge": lambda m: sq(m, 3, 3, 7, 7),
    "multi": lambda m: m.MultiPolygon((sq(m, 0, 0, 1, 1), sq(m, 20, 20, 21, 21))),
    "x_line": lambda m: line(m, (0, 0), (4, 4)),
    "x_line2": lambda m: line(m, (0, 4), (4, 0)),
    "t_line": lambda m: line(m, (2, 2), (2, 6)),
    "end_touch": lambda m: line(m, (4, 4), (6, 6)),
    "collinear": lambda m: line(m, (2, 0), (6, 0)),
    "collinear_in": lambda m: line(m, (1, 0), (3, 0)),
    "base_edge": lambda m: line(m, (0, 0), (4, 0)),
    "gap_line": lambda m: m.MultiLineString((line(m, (0, 0), (1, 0)), line(m, (2, 0), (4, 0)))),
    "through": lambda m: line(m, (-1, 2), (5, 2)),
    "ends_on_edge": lambda m: line(m, (-2, 2), (0, 2)),
    "enters_stops": lambda m: line(m, (-1, 2), (2, 2)),
    "ring": lambda m: line(m, (0, 0), (4, 0), (4, 4), (0, 4), (0, 0)),
    "pt_in": lambda m: m.Point(2.0, 2.0),
    "pt_edge": lambda m: m.Point(4.0, 2.0),
    "pt_vertex": lambda m: m.Point(4.0, 4.0),
    "pt_out": lambda m: m.Point(9.0, 9.0),
    "pt_line_end": lambda m: m.Point(0.0, 0.0),
    "mpt": lambda m: m.MultiPoint((m.Point(2.0, 2.0), m.Point(9.0, 9.0))),
    "mpt2": lambda m: m.MultiPoint((m.Point(2.0, 2.0), m.Point(3.0, 3.0))),
}
PATTERNS = ["T*T***T**", "T********", "FF*FF****", "T*F**FFF*", "F***T****", "212101212", "*T*******"]


def _same_relations(ta, tb_, ja, jb_):
    assert tp.geometry_intersects(ta, tb_) == jp.geometry_intersects(ja, jb_)
    assert tp.geometry_within(ta, tb_) == jp.geometry_within(ja, jb_)
    assert tp.geometry_touches(ta, tb_) == jp.geometry_touches(ja, jb_)
    assert tp.geometry_crosses(ta, tb_) == jp.geometry_crosses(ja, jb_)
    assert tp.geometry_overlaps(ta, tb_) == jp.geometry_overlaps(ja, jb_)
    matrix = tp.geometry_relate(ta, tb_)
    assert matrix == jp.geometry_relate(ja, jb_)
    for p in PATTERNS:
        assert tp.relate_matches(matrix, p) == jp.relate_matches(matrix, p)
        assert tp.geometry_relate_matches(ta, tb_, p) == jp.geometry_relate_matches(ja, jb_, p)


@pytest.mark.parametrize("left", sorted(CASES))
def test_constructed_pairs_match(left):
    ta, ja = _both(CASES[left])
    for right in sorted(CASES):
        tb_, jb_ = _both(CASES[right])
        assert tp.geometry_dimension(ta) == jp.geometry_dimension(ja)
        _same_relations(ta, tb_, ja, jb_)


def _random_geom(m, rng):
    k = rng.integers(0, 4)
    if k == 0:
        x0, y0 = rng.integers(0, 12, 2)
        w, h = rng.integers(1, 6, 2)
        return sq(m, float(x0), float(y0), float(x0 + w), float(y0 + h))
    if k == 1:
        return m.LineString(rng.integers(0, 12, (rng.integers(2, 5), 2)).astype(float))
    if k == 2:
        return m.Point(*(float(v) for v in rng.integers(0, 12, 2)))
    x0, y0 = rng.integers(0, 8, 2)
    return m.MultiPolygon((sq(m, float(x0), float(y0), float(x0 + 2), float(y0 + 2)),
                           sq(m, float(x0 + 3), float(y0 + 3), float(x0 + 5), float(y0 + 5))))


@pytest.mark.parametrize("seed", range(4))
def test_random_lattice_pairs_match(seed):
    for _ in range(40):
        s = np.random.SeedSequence([seed, _]).generate_state(1)[0]
        ta, tb_ = _random_geom(tb, np.random.default_rng(s)), _random_geom(tb, np.random.default_rng(s + 1))
        ja, jb_ = _random_geom(jb, np.random.default_rng(s)), _random_geom(jb, np.random.default_rng(s + 1))
        _same_relations(ta, tb_, ja, jb_)


def test_segments_and_interior_points_match():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 6, (500, 8)).astype(float)
    a[:4] = [[0, 0, 4, 4, 0, 4, 4, 0], [0, 0, 2, 0, 1, 0, 3, 0], [0, 0, 1, 1, 1, 1, 2, 2],
             [0, 0, 1, 0, 2, 0, 3, 0]]
    np.testing.assert_array_equal(tp.segments_intersect(*a.T), jp.segments_intersect(*a.T))
    for name in ("A", "holed", "hole_edge"):
        t, j = _both(CASES[name])
        assert tp.interior_point(t) == jp.interior_point(j)
    for bad in ("TTT", "T*T***T*X"):
        with pytest.raises(ValueError):
            tp.validate_de9im_pattern(bad)
        with pytest.raises(ValueError):
            jp.validate_de9im_pattern(bad)


# -- evaluate_host: the ECQL relations on point and polygon data ---------------

RELATION_FILTERS = [
    "TOUCHES(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "CROSSES(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "OVERLAPS(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "EQUALS(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "RELATE(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)), 'T********')",
    "RELATE(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)), 'T*F**F***')",
    "RELATE(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)), 'FF*FF****')",
    "TOUCHES(geom, LINESTRING (0 0, 4 4))",
    "CROSSES(geom, LINESTRING (-1 2, 5 2))",
    "INTERSECTS(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
    "CONTAINS(geom, POINT (2 2))",
    "DISJOINT(geom, POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0)))",
]


def _points(n=200):
    """Points around the square [0, 4]^2: half on the integer lattice (its
    vertices and edges among them), a quarter on the x = 4 edge line, a
    quarter off the lattice."""
    rng = np.random.default_rng(17)
    xy = rng.integers(-2, 7, (n, 2)).astype(float)
    xy[: n // 4, 0] = 4.0  # on the x = 4 edge line
    xy[n // 4: n // 2] = rng.uniform(-2, 6, (n // 4, 2))
    return xy


def _polygons(n=200):
    rng = np.random.default_rng(19)
    out = []
    for i in range(n):
        x0, y0 = (float(v) for v in rng.integers(-3, 7, 2))
        w, h = (float(v) for v in rng.integers(1, 5, 2))
        if i % 5 == 0:
            out.append(f"LINESTRING ({x0} {y0}, {x0 + w} {y0 + h})")
        elif i % 7 == 0:
            out.append("POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))")
        else:
            out.append(f"POLYGON (({x0} {y0}, {x0 + w} {y0}, {x0 + w} {y0 + h}, {x0} {y0 + h}, {x0} {y0}))")
    return np.array(out, dtype=object)


@pytest.mark.parametrize("kind", ["point", "polygon"])
@pytest.mark.parametrize("ecql", RELATION_FILTERS, ids=lambda s: s[:40])
def test_evaluate_host_relations_match(kind, ecql):
    spec = "*geom:Point:srid=4326" if kind == "point" else "*geom:Polygon:srid=4326"
    col = _points() if kind == "point" else _polygons()
    got = evaluate_host(parse_ecql(ecql), FeatureBatch.from_columns(SimpleFeatureType.create("r", spec), {"geom": col}))
    want = jevaluate(jparse(ecql), JBatch.from_columns(JSFT.create("r", spec), {"geom": col}))
    np.testing.assert_array_equal(got, want)


def test_point_relation_counts_are_not_empty():
    """The probe of the re-anchor: TOUCHES and RELATE 'T********' count
    rows on point data (the port used to raise)."""
    spec = "*geom:Point:srid=4326"
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("r", spec), {"geom": _points()})
    touches = int(evaluate_host(parse_ecql(RELATION_FILTERS[0]), batch).sum())
    relate = int(evaluate_host(parse_ecql(RELATION_FILTERS[4]), batch).sum())
    assert touches > 0 and relate > 0


def test_wkt_shapes_parse_to_the_same_coordinates():
    from geomesa_tpu.geom.wkt import parse_wkt as jparse_wkt

    texts = [
        "LINESTRING (0 0, 1.5 2.25, -3 4)",
        "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (3 3, 7 3, 7 7, 3 7, 3 3))",
        "MULTIPOINT ((1 2), (3 4))",
        "MULTIPOINT (1 2, 3 4)",
        "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3, 4 5))",
        "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 9 5, 9 9, 5 5), (6 6, 7 6, 7 7, 6 6)))",
    ]

    def coords(g):
        if hasattr(g, "x"):
            return [(g.x, g.y)]
        for part in ("coords", "shell"):
            if hasattr(g, part):
                rings = [getattr(g, part)] + list(getattr(g, "holes", ()))
                return [np.asarray(r).tolist() for r in rings]
        parts = getattr(g, "points", None) or getattr(g, "lines", None) or g.polygons
        return [coords(p) for p in parts]

    for t in texts:
        got, want = parse_wkt(t), jparse_wkt(t)
        assert type(got).__name__ == type(want).__name__
        assert coords(got) == coords(want)
        e, je = got.envelope, want.envelope
        assert (e.xmin, e.ymin, e.xmax, e.ymax) == (je.xmin, je.ymin, je.xmax, je.ymax)
