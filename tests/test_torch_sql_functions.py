"""Port parity for the spatial SQL function library: ``geomesa_tpu_torch``'s
``sql/functions.py`` (every ``st_*`` of ``FUNCTIONS``), ``geom/clip.py``,
``geom/geohash.py`` and ``geom/wkb.py`` against ``geomesa_tpu``'s, on the
same seeded inputs.

Each input is built once as plain numpy arrays and materialized in both
packages' geometry types. Every result is compared exactly: geometries
class for class and ring for ring (``np.array_equal``, NaN-aware), bytes
and strings equal, floats bit-equal (NaN equal to NaN). An input that makes
the reference raise must make the port raise the same exception type with
the same message. No tolerance is needed: the port runs the counterpart's
float64 numpy formulas in the same order.
"""

import json

import numpy as np
import pytest

import geomesa_tpu.geom.base as jbase
import geomesa_tpu.sql.functions as JF
from geomesa_tpu.geom import clip as jclip
from geomesa_tpu.geom import geohash as jgeohash
from geomesa_tpu.geom import wkb as jwkb
from geomesa_tpu.sql import FUNCTIONS as JFUNCTIONS
from geomesa_tpu_torch import sql as tsql
from geomesa_tpu_torch.geom import base as tbase
from geomesa_tpu_torch.geom import clip as tclip
from geomesa_tpu_torch.geom import geohash as tgeohash
from geomesa_tpu_torch.geom import wkb as twkb
from geomesa_tpu_torch.sql import FUNCTIONS, functions as TF

RNG = np.random.default_rng(20260101)


def _ring(coords):
    c = np.asarray(coords, np.float64)
    return np.concatenate([c, c[:1]]) if not np.array_equal(c[0], c[-1]) else c


def _star(rng, cx, cy, r_lo, r_hi, k):
    base = np.arange(k) * (2 * np.pi / k)
    th = base + rng.uniform(-0.3, 0.3, k) * (2 * np.pi / k)
    rr = rng.uniform(r_lo, r_hi, k)
    return _ring(np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], axis=1))


# -- inputs as plain specs: ("Point", x, y), ("LineString", coords),
# -- ("Polygon", shell, holes), ("MultiPoint", parts), ... ------------------

def P(x, y):
    return ("Point", float(x), float(y))


def L(coords):
    return ("LineString", np.asarray(coords, np.float64))


def A(shell, *holes):
    return ("Polygon", _ring(shell), tuple(_ring(h) for h in holes))


def MP(*pts):
    return ("MultiPoint", tuple(pts))


def ML(*lines):
    return ("MultiLineString", tuple(lines))


def MA(*polys):
    return ("MultiPolygon", tuple(polys))


def make(base, spec):
    """A spec as ``base``'s geometry (``base`` is one package's geom.base)."""
    kind = spec[0]
    if kind == "Point":
        return base.Point(spec[1], spec[2])
    if kind == "LineString":
        return base.LineString(spec[1].copy())
    if kind == "Polygon":
        return base.Polygon(spec[1].copy(), tuple(h.copy() for h in spec[2]))
    if kind == "MultiPoint":
        return base.MultiPoint(tuple(make(base, p) for p in spec[1]))
    if kind == "MultiLineString":
        return base.MultiLineString(tuple(make(base, p) for p in spec[1]))
    if kind == "MultiPolygon":
        return base.MultiPolygon(tuple(make(base, p) for p in spec[1]))
    raise TypeError(kind)


class Col:
    """An object column of specs."""

    def __init__(self, *specs):
        self.specs = specs


def build(base, v):
    """Materialize an argument: specs and spec columns become ``base``'s
    geometries, lists are walked, arrays and scalars pass through."""
    if isinstance(v, tuple) and v and v[0] in ("Point", "LineString", "Polygon", "MultiPoint",
                                                "MultiLineString", "MultiPolygon"):
        return make(base, v)
    if isinstance(v, Col):
        return np.array([make(base, s) for s in v.specs] + [None], dtype=object)[:-1]
    if isinstance(v, list):
        return [build(base, x) for x in v]
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


SQUARE = A([(0, 0), (4, 0), (4, 4), (0, 4)])
OFFSET = A([(2, 2), (6, 2), (6, 6), (2, 6)])
TRIANGLE = A([(1, -1), (5, 3), (1, 5)])
CONCAVE = A([(0, 0), (6, 0), (6, 6), (3, 2.5), (0, 6)])
DISJOINT = A([(10, 10), (12, 10), (12, 12), (10, 12)])
INNER = A([(1, 1), (2, 1), (2, 2), (1, 2)])
HOLED = A([(0, 0), (8, 0), (8, 8), (0, 8)], [(3, 3), (5, 3), (5, 5), (3, 5)])
TOUCHING = A([(4, 0), (8, 0), (8, 4), (4, 4)])
CORNER = A([(4, 4), (6, 4), (6, 6), (4, 6)])
BOWTIE = A([(0, 0), (2, 2), (2, 0), (0, 2)])
MULTI = MA(A([(0, 0), (1, 0), (1, 1), (0, 1)]), A([(3, 3), (5, 3), (5, 4)]))
LINE = L([(-1, -1), (2, 1), (5, 0.5), (9, 3)])
CLOSED = L([(0, 0), (3, 0), (3, 3), (0, 0)])
CROSSING_LINE = L([(0, 0), (3, 3), (3, 0), (0, 3)])
MLINE = ML(L([(0, 0), (1, 1)]), L([(2, 2), (3, 1), (2, 2)]))
MPOINT = MP(P(0.5, 0.5), P(7, 7), P(2, 3))
PT = P(1.25, 2.5)
PT_EDGE = P(4.0, 2.0)
PT_FAR = P(20.0, -3.0)
EAST = A([(175, 10), (185, 10), (185, 20), (175, 20)])
WEST = A([(-185, -5), (-175, -5), (-175, 5), (-185, 5)], [(-182, -1), (-178, -1), (-178, 1), (-182, 1)])
GEOS = Col(PT, LINE, SQUARE, HOLED, MULTI, MPOINT, MLINE, CLOSED)
POLYS = Col(SQUARE, OFFSET, TRIANGLE, CONCAVE, DISJOINT, HOLED)
POLYS2 = Col(OFFSET, TRIANGLE, INNER, SQUARE, CONCAVE, TOUCHING)
LINES = Col(LINE, CLOSED, CROSSING_LINE)
POINTS = Col(PT, PT_EDGE, PT_FAR, P(0, 0), P(-3.5, 7.25))
PTS = np.round(RNG.uniform(-2, 10, (257, 2)) * 64) / 64
PTS[:8] = [[0, 0], [4, 2], [2, 4], [1.25, 2.5], [8, 8], [3, 3], [4, 4], [-1, -1]]
LONLAT = np.stack([RNG.uniform(-179, 179, 200), RNG.uniform(-80, 80, 200)], axis=1)
LONLAT[:4] = [[0, 0], [10, 0], [-170, 45], [179.9, -79.9]]
UTM33 = np.stack([RNG.uniform(12, 18, 50), RNG.uniform(-60, 70, 50)], axis=1)
XS, YS = PTS[:, 0].copy(), PTS[:, 1].copy()
WKTS = ["POINT (1 2)", "LINESTRING (0 0, 1 1, 2 0)", "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
        "MULTIPOINT ((1 1), (2 2))", "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3))",
        "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((3 3, 4 3, 4 4, 3 3)))"]
GEOJSON = [{"type": "Point", "coordinates": [1.5, -2.0]},
           {"type": "Polygon", "coordinates": [[[0, 0], [2, 0], [2, 2], [0, 0]]]},
           json.dumps({"type": "LineString", "coordinates": [[0, 0], [1, 2], [3, 1]]})]
HASHES = ["u4pruydqqvj", "9q8yy", "s00000000000", "zzzzzz", "7zzzzzz"]


#: function name -> argument tuples, scalar and column calls (a call the
#: reference refuses is compared by its raise)
CASES = {
    "st_point": [(1.5, 2.5), (XS, YS)],
    "st_makePoint": [(1.5, 2.5), (XS, YS)],
    "st_makePointM": [(1.5, 2.5, 9.0), (XS, YS, XS)],
    "st_makeBBOX": [(0.0, -1.0, 2.5, 3.0)],
    "st_makeBox2D": [(-10.0, -5.0, 10.0, 5.0)],
    "st_geomFromWKT": [(WKTS[2],), (WKTS,)],
    "st_geomFromText": [(WKTS[0],), (WKTS,)],
    "st_geometryFromText": [(WKTS[4],), (WKTS,)],
    "st_geomFromWKB": [("wkb", HOLED), ("wkbs", GEOS)],
    "st_pointFromWKB": [("wkb", PT), ("wkbs", POINTS), ("wkb", LINE)],
    "st_geomFromGeoJSON": [(GEOJSON[0],), (GEOJSON,)],
    "st_geomFromGeoHash": [(HASHES[0],), (HASHES,), (HASHES[0], 5)],
    "st_box2DFromGeoHash": [(HASHES[1],), (HASHES, 3)],
    "st_pointFromGeoHash": [(HASHES[0],), (HASHES,)],
    "st_pointFromText": [(WKTS[0],), (["POINT (3 4)", "POINT (-1 0.5)"],), (WKTS[1],)],
    "st_lineFromText": [(WKTS[1],), ([WKTS[1], WKTS[1]],), (WKTS,)],
    "st_polygonFromText": [(WKTS[2],), ([WKTS[2]],), (WKTS[0],)],
    "st_mPointFromText": [(WKTS[3],), ([WKTS[3]],)],
    "st_mLineFromText": [(WKTS[4],), ([WKTS[4]],)],
    "st_mPolyFromText": [(WKTS[5],), ([WKTS[5]],)],
    "st_castToPoint": [(PT,), (POINTS,), (LINE,)],
    "st_castToLineString": [(LINE,), (LINES,), (SQUARE,)],
    "st_castToPolygon": [(SQUARE,), (POLYS,), (GEOS,)],
    "st_castToGeometry": [(SQUARE,), (GEOS,), (PTS,)],
    "st_byteArray": [("abc",), (b"xy",), (["a", b"b", "é"],)],
    "st_x": [(PT,), (PTS,), (GEOS,)],
    "st_y": [(PT,), (PTS,), (GEOS,)],
    "st_envelope": [(HOLED,), (PTS[:20],), (GEOS,)],
    "st_area": [(HOLED,), (MULTI,), (PTS,), (GEOS,)],
    "st_length": [(LINE,), (HOLED,), (PTS,), (GEOS,)],
    "st_centroid": [(MULTI,), (PT,), (PTS,), (GEOS,)],
    "st_numPoints": [(HOLED,), (PT,), (PTS,), (GEOS,)],
    "st_bufferPoint": [(PT, 1500.0), (PTS[:10], 250.0, 8), (POINTS, 10.0)],
    "st_intersects": [(SQUARE, OFFSET), (PTS, HOLED), (HOLED, PTS), (PTS, LINE), (POLYS, SQUARE),
                      (SQUARE, POLYS), (POLYS, POLYS2), (PT, PT), (PTS, MULTI)],
    "st_disjoint": [(SQUARE, DISJOINT), (PTS, HOLED), (POLYS, POLYS2)],
    "st_contains": [(HOLED, PT), (HOLED, PTS), (PTS, PT), (PTS, SQUARE), (POLYS, INNER),
                    (SQUARE, POLYS), (POLYS, POLYS2), (PTS, MULTI), (LINE, PTS[:30])],
    "st_within": [(INNER, SQUARE), (PTS, HOLED), (HOLED, PTS), (POLYS2, POLYS), (PT, PTS)],
    "st_covers": [(SQUARE, INNER), (SQUARE, PTS), (POLYS, POLYS2)],
    "st_crosses": [(CROSSING_LINE, SQUARE), (LINES, SQUARE), (LINES, LINES)],
    "st_touches": [(SQUARE, TOUCHING), (SQUARE, CORNER), (POLYS, POLYS2), (PTS[:40], SQUARE)],
    "st_overlaps": [(SQUARE, OFFSET), (POLYS, POLYS2), (SQUARE, INNER)],
    "st_relate": [(SQUARE, OFFSET), (LINE, HOLED), (POLYS, POLYS2), (SQUARE, PTS[:20])],
    "st_relateBool": [(SQUARE, OFFSET, "T*T***T**"), (POLYS, POLYS2, "T********"),
                      (SQUARE, PTS[:20], "T*****FF*")],
    "st_equals": [(SQUARE, SQUARE), (SQUARE, OFFSET), (PTS, PT), (PT, PTS), (POLYS, POLYS),
                  (POLYS, POLYS2), (SQUARE, LINE)],
    "st_distance": [(SQUARE, DISJOINT), (PT, PT_FAR), (PTS, PT), (PT, PTS), (PTS, PTS[::-1]),
                    (PTS[:40], HOLED), (POLYS, POLYS2), (LINE, HOLED), (MPOINT, MLINE)],
    "st_dwithin": [(SQUARE, DISJOINT, 8.5), (PTS, PT, 2.0), (PTS[:40], HOLED, 0.5),
                   (POLYS, POLYS2, 0.25)],
    "st_distanceSphere": [(P(0, 0), P(10, 10)), (LONLAT, P(2.35, 48.86)), (LONLAT, LONLAT[::-1]),
                          (POINTS, P(1, 1))],
    "st_distanceSpheroid": [(P(0, 0), P(10, 10)), (LONLAT, P(2.35, 48.86)),
                            (LONLAT, LONLAT[::-1]), (POINTS, P(1, 1)), (P(0, 0), P(179.7, 0.3)),
                            (P(0, 0), P(0, 0)), (P(-10, 5), P(170, -5))],
    "st_azimuth": [(P(0, 0), P(1, 1)), (P(0, 0), P(0, 0)), (LONLAT, P(0, 0)), (POINTS, P(1, 1))],
    "st_makeLine": [(PTS[:6],), ([PT, PT_FAR, PT_EDGE],)],
    "st_makePolygon": [(CLOSED,), (PTS[:5],), (L([(0, 0), (2, 0), (2, 2)]),)],
    "st_polygon": [(CLOSED,), (Col(CLOSED, CLOSED),), (LINE,), (SQUARE,)],
    "st_geometryType": [(HOLED,), (GEOS,), (PTS[:5],)],
    "st_isEmpty": [(PT,), (P(np.nan, np.nan),), (GEOS,), (MA(),)],
    "st_isCollection": [(MULTI,), (SQUARE,), (GEOS,)],
    "st_isClosed": [(CLOSED,), (LINE,), (MLINE,), (GEOS,)],
    "st_isRing": [(CLOSED,), (LINE,), (GEOS,)],
    "st_dimension": [(PT,), (LINE,), (SQUARE,), (GEOS,)],
    "st_coordDim": [(PT,), (GEOS,)],
    "st_numGeometries": [(MULTI,), (PT,), (GEOS,)],
    "st_geometryN": [(MULTI, 2), (MPOINT, 1), (MLINE, 2), (SQUARE, 1), (SQUARE, 2), (GEOS, 1)],
    "st_exteriorRing": [(HOLED,), (POLYS,), (LINE,)],
    "st_interiorRingN": [(HOLED, 1), (Col(HOLED, HOLED), 1), (LINE, 1)],
    "st_pointN": [(LINE, 2), (LINE, -1), (LINES, 3), (SQUARE, 1)],
    "st_startPoint": [(LINE,), (LINES,)],
    "st_endPoint": [(LINE,), (LINES,)],
    "st_asText": [(HOLED,), (GEOS,), (PTS[:10],)],
    "st_asWKT": [(MULTI,), (GEOS,)],
    "st_asBinary": [(HOLED,), (GEOS,), (PTS[:10],)],
    "st_asWKB": [(MLINE,), (GEOS,)],
    "st_asTWKB": [(HOLED,), (GEOS,), (GEOS, 3), (LINE, 0), (PTS[:10], 5)],
    "st_asGeoJSON": [(HOLED,), (GEOS,), (PTS[:10],)],
    "st_geoHash": [(PT,), (P(-122.4, 37.77), 12), (LONLAT,), (LONLAT, 5), (POINTS,), (GEOS,)],
    "st_translate": [(HOLED, 1.5, -2.0), (GEOS, -3.0, 0.25), (PTS[:10], 1.0, 1.0)],
    "st_convexHull": [(CONCAVE,), (MPOINT,), (P(1, 1),), (MP(P(0, 0), P(1, 1)),), (GEOS,)],
    "st_closestPoint": [(HOLED, P(4, 9)), (LINE, PT_FAR), (PT, PT_FAR), (POLYS, P(3, 7)),
                        (SQUARE, SQUARE)],
    "st_lengthSphere": [(LINE,), (LINES,), (HOLED,)],
    "st_lengthSpheroid": [(LINE,), (LINES,), (HOLED,)],
    "st_antimeridianSafeGeom": [(EAST,), (WEST,), (MA(EAST, SQUARE),), (P(190, 5),), (SQUARE,),
                                (L([(170, 0), (190, 1)]),), (Col(EAST, WEST, SQUARE),)],
    "st_idlSafeGeom": [(EAST,), (Col(WEST, P(-200, 1)),)],
    "st_isSimple": [(BOWTIE,), (SQUARE,), (CROSSING_LINE,), (LINE,), (GEOS,), (Col(BOWTIE, MULTI),)],
    "st_isValid": [(BOWTIE,), (SQUARE,), (HOLED,), (L([(0, 0)]),), (GEOS,), (Col(BOWTIE, MLINE),)],
    "st_boundary": [(SQUARE,), (HOLED,), (MULTI,), (LINE,), (CLOSED,), (MLINE,), (PT,), (GEOS,)],
    "st_rotate": [(HOLED, 0.7), (GEOS, -1.3), (PTS[:10], np.pi / 3)],
    "st_scale": [(HOLED, 2.0, 0.5), (GEOS, -1.0, 3.0)],
    "st_transform": [(LONLAT, "EPSG:4326", "EPSG:3857"), (LONLAT * [1, 0.5], "4326", "3857"),
                     (UTM33, "EPSG:4326", "EPSG:32633"), (UTM33 * [1, -1], "epsg:4326", "EPSG:32733"),
                     ("utm", "EPSG:32633", "EPSG:4326"), ("merc", "EPSG:3857", "EPSG:32633"),
                     (HOLED, "EPSG:4326", "EPSG:3857"), (GEOS, "4326", "900913"),
                     (SQUARE, "EPSG:4326", "EPSG:4326"), (PTS, "EPSG:4326", "EPSG:27700"),
                     (LONLAT, "EPSG:4326", "EPSG:32633"), (P(179, 10), "CRS84", "EPSG:32601")],
    "st_intersection": [(SQUARE, OFFSET), (SQUARE, POLYS), (POLYS, SQUARE), (POLYS, POLYS2),
                        (HOLED, OFFSET), (MULTI, SQUARE)],
    "st_union": [(SQUARE, OFFSET), (SQUARE, POLYS), (POLYS, POLYS2), (HOLED, INNER)],
    "st_difference": [(SQUARE, OFFSET), (SQUARE, INNER), (POLYS, POLYS2), (HOLED, OFFSET)],
    "st_symDifference": [(SQUARE, OFFSET), (POLYS, SQUARE), (POLYS, POLYS2)],
    "st_aggregateIntersection": [([SQUARE, OFFSET, CONCAVE],), ([],), (POLYS,)],
    "st_aggregateUnion": [([SQUARE, OFFSET, DISJOINT],), ([],), ([SQUARE, TOUCHING, CORNER],)],
}


def _args(base, wkb_mod, fns, args):
    """One call's arguments in one package: the ``"wkb"``/``"wkbs"``
    markers become that package's WKB of a spec (column), ``"utm"`` /
    ``"merc"`` projected point columns of that package."""
    mark = args[0] if isinstance(args[0], str) else None
    if mark == "wkb":
        return (wkb_mod.to_wkb(make(base, args[1])),)
    if mark == "wkbs":
        return ([wkb_mod.to_wkb(make(base, s)) for s in args[1].specs],)
    if mark == "utm":
        return (fns.st_transform(UTM33.copy(), "EPSG:4326", "EPSG:32633"),) + args[1:]
    if mark == "merc":
        return (fns.st_transform(UTM33.copy(), "EPSG:4326", "EPSG:3857"),) + args[1:]
    return tuple(build(base, a) for a in args)


def canon(v):
    """A result as plain nested values: geometries by class and arrays,
    arrays of objects element-wise."""
    if isinstance(v, (jbase.Geometry, tbase.Geometry)):
        name = type(v).__name__
        if name == "Point":
            return (name, v.x, v.y)
        if name == "LineString":
            return (name, np.asarray(v.coords))
        if name == "Polygon":
            return (name, np.asarray(v.shell), tuple(np.asarray(h) for h in v.holes))
        parts = getattr(v, {"MultiPoint": "points", "MultiLineString": "lines",
                            "MultiPolygon": "polygons"}[name])
        return (name, tuple(canon(p) for p in parts))
    if isinstance(v, (jbase.Envelope, tbase.Envelope)):
        return ("Envelope", v.xmin, v.ymin, v.xmax, v.ymax)
    if isinstance(v, np.ndarray) and v.dtype == object:
        return ("objects", v.shape, [canon(x) for x in v.ravel()])
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [canon(x) for x in v])
    return v


def same(a, b, path="") -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
        return
    if isinstance(a, tuple) or isinstance(a, list):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
        return
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
        return
    assert a == b, (path, a, b)


def _call(fn, args):
    try:
        return ("ok", canon(fn(*args)))
    except Exception as e:  # the reference's own raise: the port must match it
        return ("raised", type(e).__name__, str(e))


def test_the_registry_holds_the_reference_names():
    assert set(FUNCTIONS) == set(JFUNCTIONS) == set(CASES)
    assert set(tsql.__all__) == {"SpatialFrame", "FUNCTIONS", *FUNCTIONS}
    for name in FUNCTIONS:
        assert getattr(tsql, name) is FUNCTIONS[name]
        assert FUNCTIONS[name].__name__ == JFUNCTIONS[name].__name__  # the aliases alike


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_equals_the_reference(name):
    """Every call of ``name``'s cases, scalar and column inputs, gives the
    reference's result (or its raise)."""
    for args in CASES[name]:
        want = _call(JFUNCTIONS[name], _args(jbase, jwkb, JF, args))
        got = _call(FUNCTIONS[name], _args(tbase, twkb, TF, args))
        same(got, want, f"{name}{args!r:.80}")


def test_cases_cover_scalars_and_columns():
    """Each function with a geometry or coordinate argument has a column
    call among its cases."""
    scalar_only = {"st_makeBBOX", "st_makeBox2D", "st_makeLine", "st_makePolygon"}
    for name, calls in CASES.items():
        if name in scalar_only:
            continue
        assert any(isinstance(a, (Col, np.ndarray, list)) or (isinstance(a, str) and a in (
            "wkbs", "utm", "merc")) for args in calls for a in args), name


def test_vincenty_antipodal_fallback_equals_the_reference():
    lon1 = np.array([0.0, 0.0, 10.0, -45.0, 0.0])
    lat1 = np.array([0.0, 0.5, -20.0, 10.0, 0.0])
    lon2 = np.array([179.7, 179.9, -170.0, 135.0, 0.0])
    lat2 = np.array([0.3, -0.5, 20.0, -10.0, 0.0])
    got, want = TF._vincenty_m(lon1, lat1, lon2, lat2), JF._vincenty_m(lon1, lat1, lon2, lat2)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0.0


# -- geom/wkb.py ---------------------------------------------------------------

WKB_SPECS = [PT, P(-0.0, 1e-300), LINE, SQUARE, HOLED, MULTI, MPOINT, MLINE, CLOSED, EAST]


@pytest.mark.parametrize("i", range(len(WKB_SPECS)))
def test_wkb_and_twkb_bytes_equal_the_reference(i):
    spec = WKB_SPECS[i]
    tg, jg = make(tbase, spec), make(jbase, spec)
    data = twkb.to_wkb(tg)
    assert data == jwkb.to_wkb(jg)
    same(canon(twkb.from_wkb(data)), canon(jwkb.from_wkb(data)))
    for prec in (0, 3, 7):
        t = twkb.to_twkb(tg, prec)
        assert t == jwkb.to_twkb(jg, prec)
        same(canon(twkb.from_twkb(t)), canon(jwkb.from_twkb(t)))


def test_big_endian_wkb_reads_as_the_reference():
    import struct

    be = b"\x00" + struct.pack(">I", 1) + struct.pack(">dd", 3.5, -7.25)
    same(canon(twkb.from_wkb(be)), canon(jwkb.from_wkb(be)))
    poly = b"\x00" + struct.pack(">II", 3, 1) + struct.pack(">I", 4) + struct.pack(
        ">8d", 0, 0, 1, 0, 1, 1, 0, 0)
    same(canon(twkb.from_wkb(poly)), canon(jwkb.from_wkb(poly)))


# -- geom/geohash.py -------------------------------------------------------------


@pytest.mark.parametrize("precision", [1, 5, 9, 12])
def test_geohash_equals_the_reference(precision):
    rng = np.random.default_rng(precision)
    lon = np.concatenate([rng.uniform(-180, 180, 500), [-180, 180, 0, -0.0, 179.9999999]])
    lat = np.concatenate([rng.uniform(-90, 90, 500), [-90, 90, 0, 0.0, -89.9999999]])
    got, want = tgeohash.encode(lon, lat, precision), jgeohash.encode(lon, lat, precision)
    assert got.tolist() == want.tolist()
    assert tgeohash.encode(1.5, -2.5, precision) == jgeohash.encode(1.5, -2.5, precision)
    for h in got[:50].tolist() + HASHES:
        assert tgeohash.decode(h) == jgeohash.decode(h)
        assert tgeohash.decode_bbox(h) == jgeohash.decode_bbox(h)
        assert tgeohash.neighbors(h) == jgeohash.neighbors(h)


@pytest.mark.parametrize("box,precision", [((-10.0, 35.0, 30.0, 60.0), 2), ((2.2, 48.8, 2.5, 48.9), 5),
                                            ((179.5, -1.0, 180.0, 1.0), 4)])
def test_bbox_geohashes_equal_the_reference(box, precision):
    assert tgeohash.bbox_geohashes(*box, precision) == jgeohash.bbox_geohashes(*box, precision)


# -- geom/clip.py ------------------------------------------------------------------

FAR = 1.2e7
CLIP_PAIRS = {
    "overlapping": (SQUARE, OFFSET),
    "triangle": (SQUARE, TRIANGLE),
    "concave": (CONCAVE, OFFSET),
    "disjoint": (SQUARE, DISJOINT),
    "contained": (SQUARE, INNER),
    "shared_edge": (SQUARE, TOUCHING),
    "shared_vertex": (SQUARE, CORNER),
    "holed_vs_square": (HOLED, OFFSET),
    "holed_vs_holed": (HOLED, A([(1, 1), (9, 1), (9, 9), (1, 9)], [(4, 4), (6, 4), (6, 6), (4, 6)])),
    "hole_outside": (HOLED, A([(-2, -2), (2, -2), (2, 2), (-2, 2)])),
    "interlocking_holes": (
        A([(0, 0), (10, 0), (10, 10), (0, 10)],
          [(2, 2), (5, 2), (5, 3), (3, 3), (3, 5), (5, 5), (5, 6), (2, 6)]),
        A([(0, 0), (10, 0), (10, 10), (0, 10)],
          [(6, 2), (6, 6), (3.5, 6.5), (3.5, 5.5), (5.5, 5.5), (5.5, 2.5), (4, 2.5), (4, 1.5), (6, 1.5)])),
    "island_in_hole": (SQUARE, MA(A([(0, 0), (10, 0), (10, 10), (0, 10)], [(2, 2), (8, 2), (8, 8), (2, 8)]),
                                  A([(4, 4), (6, 4), (6, 6), (4, 6)]))),
    "far_from_origin": (A([(FAR, FAR), (FAR + 1e-3, FAR), (FAR + 1e-3, FAR + 1e-3), (FAR, FAR + 1e-3)]),
                        A([(FAR + 2e-4, FAR), (FAR + 8e-4, FAR), (FAR + 8e-4, FAR + 5e-4),
                           (FAR + 2e-4, FAR + 5e-4)])),
    "multi": (MULTI, SQUARE),
}
_FUZZ = np.random.default_rng(77)
for _k in range(6):
    _holes = [_star(_FUZZ, 0, 0, 0.5, 1.4, 6)] if _k % 2 else []
    _off = _FUZZ.uniform(-3, 3, 2)
    CLIP_PAIRS[f"star_{_k}"] = (("Polygon", _star(_FUZZ, 0, 0, 3.0, 6.0, int(_FUZZ.integers(8, 14))),
                                 tuple(_holes)),
                                ("Polygon", _star(_FUZZ, _off[0], _off[1], 2.5, 5.5,
                                                  int(_FUZZ.integers(8, 14))), ()))
CLIP_OPS = ("polygon_intersection", "polygon_union", "polygon_difference", "polygon_sym_difference")


@pytest.mark.parametrize("op", CLIP_OPS)
@pytest.mark.parametrize("case", sorted(CLIP_PAIRS))
def test_clip_equals_the_reference_ring_for_ring(case, op):
    """Both argument orders; the degenerate cases go through the
    perturbation retries, the refusals raise alike."""
    a, b = CLIP_PAIRS[case]
    for x, y in ((a, b), (b, a)):
        want = _call(getattr(jclip, op), (make(jbase, x), make(jbase, y)))
        got = _call(getattr(tclip, op), (make(tbase, x), make(tbase, y)))
        same(got, want, f"{case} {op}")


@pytest.mark.parametrize("op", ["intersection", "union", "difference"])
def test_clip_rings_equals_the_reference(op):
    ra, rb = np.asarray(SQUARE[1][:-1]), np.asarray(TOUCHING[1][:-1])
    same(canon(tclip.clip_rings(ra, rb, op)), canon(jclip.clip_rings(ra, rb, op)))
