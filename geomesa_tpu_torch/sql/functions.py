"""Vectorized ``st_*`` spatial functions.

Copy of ``geomesa_tpu/sql/functions.py`` (ref: geomesa-spark-sql
GeometricConstructorFunctions / GeometricAccessorFunctions /
SpatialRelationFunctions / GeometricProcessingFunctions), over the port's
``geom/`` (``predicates``, ``clip``, ``geohash``, ``wkb``, ``wkt``,
``geojson``). The segment list and the clamped point-to-segment
projection are ``geom/predicates.py``'s ``distance_segments`` and
``pt_seg_project``, which proximity search shares. ``FUNCTIONS`` holds
the same names as the counterpart's registry (``:1642``).

Conventions:
- A *point column* is an (n, 2) float64 array; a *geometry column* is an
  object array of geom.base Geometry; a scalar Geometry broadcasts.
- Relations return bool arrays (or bool for scalar/scalar).
- Names and argument order mirror the reference's Spark UDFs
  (``st_contains(a, b)`` = a contains b).
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geom.base import (
    Envelope,
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)
from geomesa_tpu_torch.geom.predicates import (
    geometry_crosses,
    geometry_intersects,
    geometry_overlaps,
    geometry_relate,
    geometry_relate_matches,
    geometry_touches,
    geometry_within,
    points_in_polygon,
    pt_seg_project,
)
from geomesa_tpu_torch.geom.predicates import distance_segments as _segments_of

EARTH_RADIUS_M = 6_371_008.8


# -- constructors ------------------------------------------------------------


def st_point(x, y):
    """(x, y) columns -> point column; scalars -> Point."""
    if np.isscalar(x) and np.isscalar(y):
        return Point(float(x), float(y))
    return np.stack(
        [np.asarray(x, np.float64), np.asarray(y, np.float64)], axis=1
    )


def st_makeBBOX(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    return Polygon(
        np.array(
            [
                (xmin, ymin),
                (xmax, ymin),
                (xmax, ymax),
                (xmin, ymax),
                (xmin, ymin),
            ],
            dtype=np.float64,
        )
    )


def st_geomFromWKT(wkt):
    from geomesa_tpu_torch.geom.wkt import parse_wkt

    if isinstance(wkt, str):
        return parse_wkt(wkt)
    return np.array([parse_wkt(w) for w in wkt], dtype=object)


def st_geomFromWKB(wkb):
    from geomesa_tpu_torch.geom.wkb import from_wkb

    if isinstance(wkb, (bytes, bytearray)):
        return from_wkb(bytes(wkb))
    return np.array([from_wkb(bytes(w)) for w in wkb], dtype=object)


# -- accessors ---------------------------------------------------------------


def _is_point_col(col) -> bool:
    return (
        isinstance(col, np.ndarray) and col.dtype != object and col.ndim == 2
    )


def st_x(geom):
    if isinstance(geom, Point):
        return geom.x
    if _is_point_col(geom):
        return np.ascontiguousarray(geom[:, 0])
    return np.array(
        [g.x if isinstance(g, Point) else np.nan for g in geom]
    )


def st_y(geom):
    if isinstance(geom, Point):
        return geom.y
    if _is_point_col(geom):
        return np.ascontiguousarray(geom[:, 1])
    return np.array(
        [g.y if isinstance(g, Point) else np.nan for g in geom]
    )


def st_envelope(geom):
    """Envelope (or array of Envelope) of geometries."""
    if isinstance(geom, Geometry):
        return geom.envelope
    if _is_point_col(geom):
        return np.array(
            [Envelope(x, y, x, y) for x, y in geom], dtype=object
        )
    return np.array([g.envelope for g in geom], dtype=object)


def _ring_area(r: np.ndarray) -> float:
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def _geom_area(g) -> float:
    if isinstance(g, Polygon):
        shell = abs(_ring_area(g.shell))
        return shell - sum(abs(_ring_area(h)) for h in g.holes)
    if isinstance(g, MultiPolygon):
        return sum(_geom_area(p) for p in g.polygons)
    return 0.0


def st_area(geom):
    if isinstance(geom, Geometry):
        return _geom_area(geom)
    if _is_point_col(geom):
        return np.zeros(len(geom))
    return np.array([_geom_area(g) for g in geom])


def _geom_length(g) -> float:
    if isinstance(g, LineString):
        d = np.diff(g.coords, axis=0)
        return float(np.hypot(d[:, 0], d[:, 1]).sum())
    if isinstance(g, MultiLineString):
        return sum(_geom_length(l) for l in g.lines)
    if isinstance(g, Polygon):
        return sum(
            float(np.hypot(*np.diff(r, axis=0).T).sum()) for r in g.rings()
        )
    if isinstance(g, MultiPolygon):
        return sum(_geom_length(p) for p in g.polygons)
    return 0.0


def st_length(geom):
    if isinstance(geom, Geometry):
        return _geom_length(geom)
    if _is_point_col(geom):
        return np.zeros(len(geom))
    return np.array([_geom_length(g) for g in geom])


def _geom_centroid(g) -> Point:
    if isinstance(g, Point):
        return g
    vs = _all_vertices(g)
    return Point(float(vs[:, 0].mean()), float(vs[:, 1].mean()))


def _all_vertices(g) -> np.ndarray:
    if isinstance(g, Point):
        return np.array([[g.x, g.y]])
    if isinstance(g, LineString):
        return g.coords
    if isinstance(g, Polygon):
        return g.shell[:-1]
    if isinstance(g, MultiPoint):
        return np.array([[p.x, p.y] for p in g.points])
    if isinstance(g, MultiLineString):
        return np.concatenate([l.coords for l in g.lines])
    if isinstance(g, MultiPolygon):
        return np.concatenate([p.shell[:-1] for p in g.polygons])
    raise TypeError(type(g))


def st_centroid(geom):
    if isinstance(geom, Geometry):
        return _geom_centroid(geom)
    if _is_point_col(geom):
        return geom.copy()
    return np.array([_geom_centroid(g) for g in geom], dtype=object)


def st_numPoints(geom):
    def n(g):
        return len(_all_vertices(g)) if not isinstance(g, Point) else 1

    if isinstance(geom, Geometry):
        return n(geom)
    if _is_point_col(geom):
        return np.ones(len(geom), dtype=np.int64)
    return np.array([n(g) for g in geom], dtype=np.int64)


def st_bufferPoint(geom, distance_m: float, segments: int = 32):
    """Geodesic-ish circular buffer around point(s) in meters (ref
    st_bufferPoint: degrees-from-meters at the point's latitude)."""

    def circle(x, y):
        dlat = np.degrees(distance_m / EARTH_RADIUS_M)
        dlon = dlat / max(np.cos(np.radians(y)), 1e-9)
        t = np.linspace(0.0, 2 * np.pi, segments + 1)
        ring = np.stack(
            [x + dlon * np.cos(t), y + dlat * np.sin(t)], axis=1
        )
        ring[-1] = ring[0]
        return Polygon(ring)

    if isinstance(geom, Point):
        return circle(geom.x, geom.y)
    if _is_point_col(geom):
        return np.array([circle(x, y) for x, y in geom], dtype=object)
    return np.array(
        [circle(g.x, g.y) for g in geom], dtype=object
    )


# -- relations ---------------------------------------------------------------


def _as_geom_scalar(g):
    return g if isinstance(g, Geometry) else None


def _pairwise(a, b, fn, point_fast=None):
    """Broadcast a relation over (column, scalar), (scalar, column),
    (column, column) or (scalar, scalar) inputs."""
    a_scalar = isinstance(a, Geometry)
    b_scalar = isinstance(b, Geometry)
    if a_scalar and b_scalar:
        return fn(a, b)
    if _is_point_col(a) and b_scalar and point_fast is not None:
        return point_fast(a, b, False)
    if a_scalar and _is_point_col(b) and point_fast is not None:
        return point_fast(b, a, True)
    av = a if not a_scalar else None
    bv = b if not b_scalar else None
    n = len(av) if av is not None else len(bv)
    out = np.empty(n, dtype=bool)
    for i in range(n):
        ga = a if a_scalar else _row_geom(a, i)
        gb = b if b_scalar else _row_geom(b, i)
        out[i] = fn(ga, gb)
    return out


def _row_geom(col, i):
    if _is_point_col(col):
        return Point(float(col[i, 0]), float(col[i, 1]))
    return col[i]


def _points_vs_geom_intersects(pts: np.ndarray, g: Geometry, flipped: bool):
    # symmetric relation: ignore flipped
    if isinstance(g, (Polygon, MultiPolygon)):
        x, y = pts[:, 0], pts[:, 1]
        if isinstance(g, Polygon):
            return points_in_polygon(x, y, g.rings())
        m = np.zeros(len(pts), dtype=bool)
        for p in g.polygons:
            m |= points_in_polygon(x, y, p.rings())
        return m
    out = np.empty(len(pts), dtype=bool)
    for i in range(len(pts)):
        out[i] = geometry_intersects(
            Point(float(pts[i, 0]), float(pts[i, 1])), g
        )
    return out


def st_intersects(a, b):
    return _pairwise(
        a, b, geometry_intersects, point_fast=_points_vs_geom_intersects
    )


def st_disjoint(a, b):
    r = st_intersects(a, b)
    return ~r if isinstance(r, np.ndarray) else not r


def st_contains(a, b):
    """a contains b (b within a)."""

    def fn(ga, gb):
        return geometry_within(gb, ga)

    def pf(pts, g, flipped):
        if flipped:
            # pts contains g: a point only contains an equal point
            if isinstance(g, Point):
                return (pts[:, 0] == g.x) & (pts[:, 1] == g.y)
            return np.zeros(len(pts), dtype=bool)
        return _points_vs_geom_intersects(pts, g, False) if isinstance(
            g, (Polygon, MultiPolygon)
        ) else np.array(
            [fn(_row_geom(pts, i), g) for i in range(len(pts))]
        )

    # st_contains(scalar_geom, point_col): the common pushdown shape
    if isinstance(a, Geometry) and not isinstance(b, Geometry):
        if _is_point_col(b):
            return pf(b, a, False)
        return np.array([fn(a, gb) for gb in b], dtype=bool)
    if isinstance(b, Geometry) and not isinstance(a, Geometry):
        if _is_point_col(a):
            return pf(a, b, True)
        return np.array([fn(ga, b) for ga in a], dtype=bool)
    return _pairwise(a, b, fn)


def st_within(a, b):
    """a within b."""
    return st_contains(b, a)


def st_crosses(a, b):
    """OGC crosses (ref SpatialRelationFunctions.ST_Crosses): interiors
    meet in a lower dimension and each geometry extends outside the
    other."""
    return _pairwise(a, b, geometry_crosses)


def st_touches(a, b):
    """OGC touches: geometries meet only at their boundaries."""
    return _pairwise(a, b, geometry_touches)


def st_overlaps(a, b):
    """OGC overlaps: same dimension, interiors partially shared, neither
    covers the other."""
    return _pairwise(a, b, geometry_overlaps)


def st_relate(a, b):
    """DE-9IM-lite matrix string per pair ('T'/'F' cells; dimension digits
    are not computed -- see geom.predicates.relate_matches)."""
    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return geometry_relate(a, b)
    av = a if not isinstance(a, Geometry) else None
    bv = b if not isinstance(b, Geometry) else None
    n = len(av) if av is not None else len(bv)
    out = np.empty(n, dtype=object)
    for i in range(n):
        ga = a if av is None else _row_geom(a, i)
        gb = b if bv is None else _row_geom(b, i)
        out[i] = geometry_relate(ga, gb)
    return out


def st_relateBool(a, b, pattern: str):
    """DE-9IM-lite pattern match (ref ST_RelateBool)."""

    def fn(ga, gb):
        return geometry_relate_matches(ga, gb, pattern)

    return _pairwise(a, b, fn)


def _pt_seg_dist(pts: np.ndarray, segs: np.ndarray) -> float:
    """min over all (point, segment) pairs of the exact point-to-segment
    distance (clamped projection)."""
    _, dist2 = pt_seg_project(pts, segs)
    return float(np.sqrt(dist2.min()))


def st_distance(a, b):
    """Exact planar distance: 0 when intersecting, else the minimum
    point-to-segment distance both ways (exact for non-crossing
    geometries, since any crossing pair would have intersected)."""

    def fn(ga, gb):
        if isinstance(ga, Point) and isinstance(gb, Point):
            return float(np.hypot(ga.x - gb.x, ga.y - gb.y))
        if geometry_intersects(ga, gb):
            return 0.0
        # point sets come from the segment endpoints so hole-ring vertices
        # participate (shells alone would overestimate near holes)
        sa, sb = _segments_of(ga), _segments_of(gb)
        pa = np.concatenate([sa[:, 0:2], sa[:, 2:4]], axis=0)
        pb = np.concatenate([sb[:, 0:2], sb[:, 2:4]], axis=0)
        return min(_pt_seg_dist(pa, sb), _pt_seg_dist(pb, sa))

    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return fn(a, b)
    if _is_point_col(a) and isinstance(b, Point):
        return np.hypot(a[:, 0] - b.x, a[:, 1] - b.y)
    if _is_point_col(b) and isinstance(a, Point):
        return np.hypot(b[:, 0] - a.x, b[:, 1] - a.y)
    if _is_point_col(a) and _is_point_col(b):
        return np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1])
    n = len(a) if not isinstance(a, Geometry) else len(b)
    return np.array(
        [
            fn(
                a if isinstance(a, Geometry) else _row_geom(a, i),
                b if isinstance(b, Geometry) else _row_geom(b, i),
            )
            for i in range(n)
        ]
    )


def st_dwithin(a, b, distance: float):
    d = st_distance(a, b)
    return d <= distance


def st_distanceSphere(a, b):
    """Haversine great-circle distance in meters between points/point
    columns (ref st_distanceSpheroid's spherical sibling)."""

    def coords(v):
        if isinstance(v, Point):
            return np.array([v.x]), np.array([v.y])
        if _is_point_col(v):
            return v[:, 0], v[:, 1]
        return (
            np.array([g.x for g in v]),
            np.array([g.y for g in v]),
        )

    ax, ay = coords(a)
    bx, by = coords(b)
    lat1, lat2 = np.radians(ay), np.radians(by)
    dlat = lat2 - lat1
    dlon = np.radians(bx - ax)
    h = (
        np.sin(dlat / 2) ** 2
        + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    )
    d = 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(h, 0, 1)))
    if isinstance(a, Point) and isinstance(b, Point):
        return float(d[0])
    return d


# -- scalar-mapping helper ---------------------------------------------------


def _map_geoms(geom, fn):
    """Apply a Geometry -> value function over a scalar or column input."""
    if isinstance(geom, Geometry):
        return fn(geom)
    if _is_point_col(geom):
        return np.array(
            [fn(Point(float(x), float(y))) for x, y in geom], dtype=object
        )
    return np.array([fn(g) for g in geom], dtype=object)


# -- typed constructors (ref GeometricConstructorFunctions) ------------------


def st_makeLine(points) -> LineString:
    """Points (Point list or (n, 2) array) -> LineString."""
    if isinstance(points, np.ndarray):
        return LineString(points)
    return LineString(
        np.array([[p.x, p.y] for p in points], dtype=np.float64)
    )


def st_makePolygon(line) -> Polygon:
    """Closed LineString (or coords) -> Polygon shell."""
    coords = line.coords if isinstance(line, LineString) else np.asarray(line)
    if not np.array_equal(coords[0], coords[-1]):
        coords = np.concatenate([coords, coords[:1]], axis=0)
    return Polygon(coords)


st_makeBox2D = st_makeBBOX  # ref alias (two corner points in the reference)


def _typed_from_text(wkt, cls, name):
    g = st_geomFromWKT(wkt)
    if isinstance(g, np.ndarray):
        if any(not isinstance(v, cls) for v in g):
            raise ValueError(f"{name} got non-{cls.__name__} WKT")
        return g
    if not isinstance(g, cls):
        raise ValueError(f"{name} got {type(g).__name__}, not {cls.__name__}")
    return g


def st_pointFromText(wkt):
    return _typed_from_text(wkt, Point, "st_pointFromText")


def st_lineFromText(wkt):
    return _typed_from_text(wkt, LineString, "st_lineFromText")


def st_polygonFromText(wkt):
    return _typed_from_text(wkt, Polygon, "st_polygonFromText")


def st_mPointFromText(wkt):
    return _typed_from_text(wkt, MultiPoint, "st_mPointFromText")


def st_mLineFromText(wkt):
    return _typed_from_text(wkt, MultiLineString, "st_mLineFromText")


def st_mPolyFromText(wkt):
    return _typed_from_text(wkt, MultiPolygon, "st_mPolyFromText")


def st_geomFromGeoJSON(doc):
    from geomesa_tpu_torch.geom.geojson import from_geojson

    if isinstance(doc, (dict, str, bytes)):
        return from_geojson(doc)
    return np.array([from_geojson(d) for d in doc], dtype=object)


def st_geomFromGeoHash(gh, precision: "int | None" = None):
    """GeoHash string -> its cell Polygon."""
    from geomesa_tpu_torch.geom import geohash

    def one(h):
        # precision counts geohash characters, same unit as st_geoHash
        (xmin, xmax), (ymin, ymax) = geohash.decode_bbox(
            h if precision is None else h[:precision]
        )
        return st_makeBBOX(xmin, ymin, xmax, ymax)

    if isinstance(gh, str):
        return one(gh)
    return np.array([one(h) for h in gh], dtype=object)


st_box2DFromGeoHash = st_geomFromGeoHash  # ref alias


def st_pointFromGeoHash(gh, precision: "int | None" = None):
    """GeoHash string -> cell-center Point."""
    from geomesa_tpu_torch.geom import geohash

    def one(h):
        lon, lat = geohash.decode(h)
        return Point(lon, lat)

    if isinstance(gh, str):
        return one(gh)
    return np.array([one(h) for h in gh], dtype=object)


def st_castToPoint(geom):
    return _cast(geom, Point)


def st_castToLineString(geom):
    return _cast(geom, LineString)


def st_castToPolygon(geom):
    return _cast(geom, Polygon)


def _cast(geom, cls):
    def one(g):
        if not isinstance(g, cls):
            raise ValueError(f"cannot cast {type(g).__name__} to {cls.__name__}")
        return g

    if isinstance(geom, Geometry):
        return one(geom)
    return _map_geoms(geom, one)


# -- accessors (ref GeometricAccessorFunctions) ------------------------------


def st_geometryType(geom):
    return _scalar_or_col(geom, lambda g: type(g).__name__)


def _scalar_or_col(geom, fn):
    if isinstance(geom, Geometry):
        return fn(geom)
    return _map_geoms(geom, fn)


def st_isEmpty(geom):
    def one(g):
        if isinstance(g, Point):
            return bool(np.isnan(g.x))
        if isinstance(g, LineString):
            return len(g.coords) == 0
        if isinstance(g, Polygon):
            return len(g.shell) == 0
        if isinstance(g, MultiPoint):
            return len(g.points) == 0
        if isinstance(g, MultiLineString):
            return len(g.lines) == 0
        if isinstance(g, MultiPolygon):
            return len(g.polygons) == 0
        return False

    return _scalar_or_col(geom, one)


def st_isCollection(geom):
    return _scalar_or_col(
        geom,
        lambda g: isinstance(g, (MultiPoint, MultiLineString, MultiPolygon)),
    )


def st_isClosed(geom):
    """Lines: first == last coordinate (points/polygons are closed)."""

    def one(g):
        if isinstance(g, LineString):
            return bool(np.array_equal(g.coords[0], g.coords[-1]))
        if isinstance(g, MultiLineString):
            return all(
                np.array_equal(l.coords[0], l.coords[-1]) for l in g.lines
            )
        return True

    return _scalar_or_col(geom, one)


def st_isRing(geom):
    def one(g):
        return isinstance(g, LineString) and bool(
            np.array_equal(g.coords[0], g.coords[-1])
        )

    return _scalar_or_col(geom, one)


def st_dimension(geom):
    def one(g):
        if isinstance(g, (Point, MultiPoint)):
            return 0
        if isinstance(g, (LineString, MultiLineString)):
            return 1
        return 2

    return _scalar_or_col(geom, one)


def st_coordDim(geom):
    return _scalar_or_col(geom, lambda g: 2)  # xy-only geometry model


def st_numGeometries(geom):
    def one(g):
        if isinstance(g, MultiPoint):
            return len(g.points)
        if isinstance(g, MultiLineString):
            return len(g.lines)
        if isinstance(g, MultiPolygon):
            return len(g.polygons)
        return 1

    return _scalar_or_col(geom, one)


def st_geometryN(geom, n: int):
    """1-based part accessor (ref/JTS convention)."""

    def one(g):
        if isinstance(g, MultiPoint):
            return g.points[n - 1]
        if isinstance(g, MultiLineString):
            return g.lines[n - 1]
        if isinstance(g, MultiPolygon):
            return g.polygons[n - 1]
        if n != 1:
            raise IndexError(f"geometry has 1 part, asked for {n}")
        return g

    return _scalar_or_col(geom, one)


def st_exteriorRing(geom):
    def one(g):
        if isinstance(g, Polygon):
            return LineString(g.shell)
        raise ValueError("st_exteriorRing needs a Polygon")

    return _scalar_or_col(geom, one)


def st_interiorRingN(geom, n: int):
    def one(g):
        if isinstance(g, Polygon):
            return LineString(g.holes[n - 1])
        raise ValueError("st_interiorRingN needs a Polygon")

    return _scalar_or_col(geom, one)


def st_pointN(geom, n: int):
    """1-based vertex accessor on lines (negative counts from the end)."""

    def one(g):
        if not isinstance(g, LineString):
            raise ValueError("st_pointN needs a LineString")
        c = g.coords[n - 1 if n > 0 else n]
        return Point(float(c[0]), float(c[1]))

    return _scalar_or_col(geom, one)


def st_startPoint(geom):
    return st_pointN(geom, 1)


def st_endPoint(geom):
    return st_pointN(geom, -1)


# -- outputs (ref SpatialEncoders / output functions) ------------------------


def st_asText(geom):
    from geomesa_tpu_torch.geom.wkt import to_wkt

    return _scalar_or_col(geom, to_wkt)


st_asWKT = st_asText


def st_asBinary(geom):
    from geomesa_tpu_torch.geom.wkb import to_wkb

    return _scalar_or_col(geom, to_wkb)


st_asWKB = st_asBinary


def st_asTWKB(geom, precision: int = 7):
    from geomesa_tpu_torch.geom.wkb import to_twkb

    return _scalar_or_col(geom, lambda g: to_twkb(g, precision))


def st_asGeoJSON(geom):
    import json

    from geomesa_tpu_torch.geom.geojson import to_geojson

    return _scalar_or_col(geom, lambda g: json.dumps(to_geojson(g)))


def st_geoHash(geom, precision: int = 9):
    """Point (or point column) -> GeoHash string(s)."""
    from geomesa_tpu_torch.geom import geohash

    if isinstance(geom, Point):
        return geohash.encode(geom.x, geom.y, precision)
    if _is_point_col(geom):
        return np.array(
            [geohash.encode(x, y, precision) for x, y in geom], dtype=object
        )

    def one(g):
        if not isinstance(g, Point):
            raise ValueError(
                f"st_geoHash needs Point geometries, got {type(g).__name__}"
            )
        return geohash.encode(g.x, g.y, precision)

    return _map_geoms(geom, one)


# -- processing (ref GeometricProcessingFunctions) ---------------------------


def _map_coords(g, fn):
    """Rebuild a geometry with transformed (n, 2) coordinate arrays."""
    if isinstance(g, Point):
        c = fn(np.array([[g.x, g.y]]))
        return Point(float(c[0, 0]), float(c[0, 1]))
    if isinstance(g, LineString):
        return LineString(fn(g.coords))
    if isinstance(g, Polygon):
        return Polygon(fn(g.shell), tuple(fn(h) for h in g.holes))
    if isinstance(g, MultiPoint):
        return MultiPoint(tuple(_map_coords(p, fn) for p in g.points))
    if isinstance(g, MultiLineString):
        return MultiLineString(tuple(_map_coords(l, fn) for l in g.lines))
    if isinstance(g, MultiPolygon):
        return MultiPolygon(tuple(_map_coords(p, fn) for p in g.polygons))
    raise ValueError(f"cannot transform {type(g).__name__}")


def st_translate(geom, dx: float, dy: float):
    def one(g):
        return _map_coords(g, lambda c: c + np.array([dx, dy]))

    return _scalar_or_col(geom, one)


def st_convexHull(geom):
    """Monotone-chain convex hull of all vertices."""

    def one(g):
        pts = np.unique(_all_vertices(g), axis=0)
        if len(pts) == 1:
            return Point(float(pts[0, 0]), float(pts[0, 1]))
        if len(pts) == 2:
            return LineString(pts)
        pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

        def half(points):
            out = []
            for p in points:
                while len(out) >= 2:
                    u = out[-1] - out[-2]
                    v = p - out[-2]
                    if u[0] * v[1] - u[1] * v[0] <= 0:  # 2d cross product
                        out.pop()
                    else:
                        break
                out.append(p)
            return out

        lower = half(pts)
        upper = half(pts[::-1])
        hull = np.array(lower[:-1] + upper[:-1])
        if len(hull) < 3:
            return LineString(np.array([pts[0], pts[-1]]))
        return Polygon(np.concatenate([hull, hull[:1]], axis=0))

    return _scalar_or_col(geom, one)


def st_closestPoint(a, b):
    """Point on geometry ``a`` closest to point ``b``."""

    def one(ga, gb):
        if not isinstance(gb, Point):
            raise ValueError("st_closestPoint expects a Point second arg")
        if isinstance(ga, Point):
            return ga
        segs = _segments_of(ga)
        pt = np.array([[gb.x, gb.y]])
        t, dist2 = pt_seg_project(pt, segs)
        j = int(dist2[0].argmin())
        sa = segs[j, 0:2]
        sd = segs[j, 2:4] - sa
        c = sa + t[0, j] * sd
        return Point(float(c[0]), float(c[1]))

    if isinstance(a, Geometry) and isinstance(b, Point):
        return one(a, b)
    return _map_geoms(a, lambda g: one(g, b))


def st_lengthSphere(geom):
    """LineString length in meters over the sphere (haversine per segment)."""

    def one(g):
        segs = _segments_of(g)
        if len(segs) == 0:
            return 0.0
        lon1, lat1, lon2, lat2 = (
            np.radians(segs[:, 0]),
            np.radians(segs[:, 1]),
            np.radians(segs[:, 2]),
            np.radians(segs[:, 3]),
        )
        h = (
            np.sin((lat2 - lat1) / 2) ** 2
            + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
        )
        return float(
            (2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(h, 0, 1)))).sum()
        )

    return _scalar_or_col(geom, one)


def st_antimeridianSafeGeom(geom):
    """Split geometries that extend past lon +/-180 into an in-range
    MultiPolygon/MultiLineString (ref st_antimeridianSafeGeom; the
    reference's buffer ops can produce lon > 180 which must be wrapped
    before indexing)."""

    def clip_ring(coords, boundary, keep_right):
        # Sutherland-Hodgman against the half-plane x <= boundary
        # (keep_right False) or x >= boundary (True)
        out = []
        n = len(coords)
        for i in range(n):
            cur, nxt = coords[i], coords[(i + 1) % n]
            cin = cur[0] >= boundary if keep_right else cur[0] <= boundary
            nin = nxt[0] >= boundary if keep_right else nxt[0] <= boundary
            if cin:
                out.append(cur)
            if cin != nin:
                tpar = (boundary - cur[0]) / (nxt[0] - cur[0])
                out.append(
                    np.array([boundary, cur[1] + tpar * (nxt[1] - cur[1])])
                )
        return np.array(out) if len(out) >= 3 else None

    def one(g):
        e = g.envelope
        if e.xmax <= 180.0 and e.xmin >= -180.0:
            return g
        if isinstance(g, Point):
            x = ((g.x + 180.0) % 360.0) - 180.0
            return Point(x, g.y)
        if isinstance(g, Polygon):
            if e.xmax > 180.0:  # spills east: split at +180
                boundary, kept_right, shift = 180.0, False, -360.0
            else:  # spills west: split at -180
                boundary, kept_right, shift = -180.0, True, 360.0

            def side(ring_, right):
                return clip_ring(ring_, boundary, keep_right=right)

            def close(r):
                return np.concatenate([r, r[:1]], axis=0)

            parts = []
            for right, dx in ((kept_right, 0.0), (not kept_right, shift)):
                shell = side(g.shell[:-1], right)
                if shell is None:
                    continue
                holes = []
                for h in g.holes:
                    hc = side(h[:-1], right)
                    if hc is not None:
                        holes.append(close(hc + np.array([dx, 0.0])))
                parts.append(
                    Polygon(close(shell + np.array([dx, 0.0])), tuple(holes))
                )
            if not parts:
                return g
            return parts[0] if len(parts) == 1 else MultiPolygon(tuple(parts))
        if isinstance(g, MultiPolygon):
            parts = []
            for p in g.polygons:
                r = one(p)
                parts.extend(
                    r.polygons if isinstance(r, MultiPolygon) else [r]
                )
            return MultiPolygon(tuple(parts))
        return g  # lines/others: left untouched

    return _scalar_or_col(geom, one)


st_idlSafeGeom = st_antimeridianSafeGeom  # ref alias


def st_equals(a, b):
    def fn(ga, gb):
        if type(ga) is not type(gb):
            return False
        if isinstance(ga, Point):
            return ga.x == gb.x and ga.y == gb.y
        va, vb = _all_vertices(ga), _all_vertices(gb)
        return va.shape == vb.shape and bool(np.allclose(va, vb))

    def point_fast(pts, g, flipped):
        if not isinstance(g, Point):
            return np.zeros(len(pts), dtype=bool)
        return (pts[:, 0] == g.x) & (pts[:, 1] == g.y)

    return _pairwise(a, b, fn, point_fast)


def st_covers(a, b):
    """a covers b (boundary-inclusive contains; approximated by contains
    with boundary tolerance on our grid model)."""
    return st_contains(a, b)


# -- constructor/cast aliases (ref naming variants) --------------------------

st_makePoint = st_point  # ref alias (jts constructor name)
st_geomFromText = st_geomFromWKT  # ref alias
st_geometryFromText = st_geomFromWKT  # ref alias


def st_makePointM(x, y, m):
    """(x, y, m) -> point; the measure coordinate is DROPPED (this
    framework's geometry model is 2-D — the reference's M rides JTS
    coordinates but no indexed operation reads it)."""
    return st_point(x, y)


def st_pointFromWKB(wkb):
    """WKB -> Point (raises if the bytes decode to a non-point)."""
    out = st_geomFromWKB(wkb)

    def check(g):
        if not isinstance(g, Point):
            raise ValueError(
                f"st_pointFromWKB decoded a {type(g).__name__}"
            )
        return g

    if isinstance(out, Geometry):
        return check(out)
    return np.array([check(g) for g in out], dtype=object)


def st_castToGeometry(geom):
    """Identity upcast (the reference narrows Spark UDT types; our
    geometry columns are already dynamically typed)."""
    return geom


def st_byteArray(s):
    """String -> UTF-8 bytes (ref utility cast)."""
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    if isinstance(s, str):
        return s.encode("utf-8")
    return np.array([st_byteArray(v) for v in s], dtype=object)


def st_polygon(line):
    """Closed LineString -> Polygon (ref st_polygon constructor)."""

    def one(g):
        if not isinstance(g, LineString):
            raise ValueError("st_polygon expects a LineString")
        c = np.asarray(g.coords, np.float64)
        if len(c) < 4 or not np.array_equal(c[0], c[-1]):
            raise ValueError("st_polygon needs a closed ring (>= 4 points)")
        return Polygon(c)

    return _scalar_or_col(line, one)


# -- additional accessors ----------------------------------------------------


def st_boundary(geom):
    """Topological boundary: polygon -> its rings as (Multi)LineString,
    linestring -> its endpoints as MultiPoint (empty when closed),
    point -> empty GeometryCollection (represented as an empty
    MultiPoint — the closest thing in this model)."""

    def one(g):
        if isinstance(g, Polygon):
            rings = [LineString(r) for r in g.rings()]
            return rings[0] if len(rings) == 1 else MultiLineString(
                tuple(rings)
            )
        if isinstance(g, MultiPolygon):
            rings = [
                LineString(r) for p in g.polygons for r in p.rings()
            ]
            return MultiLineString(tuple(rings))
        if isinstance(g, LineString):
            c = np.asarray(g.coords)
            if np.array_equal(c[0], c[-1]):
                return MultiPoint(np.empty((0, 2)))
            return MultiPoint(np.stack([c[0], c[-1]]))
        if isinstance(g, MultiLineString):
            pts = [
                p
                for l in g.lines
                for p in (
                    []
                    if np.array_equal(l.coords[0], l.coords[-1])
                    else [l.coords[0], l.coords[-1]]
                )
            ]
            return MultiPoint(
                np.stack(pts) if pts else np.empty((0, 2))
            )
        return MultiPoint(np.empty((0, 2)))  # points: empty boundary

    return _scalar_or_col(geom, one)


def _segments_self_intersect(c: np.ndarray) -> bool:
    """Any non-adjacent segment pair of the path ``c`` crosses (shared
    ring endpoints excluded)."""
    n = len(c) - 1
    if n < 2:
        return False
    a, b = c[:-1], c[1:]
    closed = np.array_equal(c[0], c[-1])
    for i in range(n - 1):
        js = np.arange(i + 2, n)
        if closed and i == 0 and len(js):
            js = js[:-1]  # last segment is adjacent to the first
        if len(js) == 0:
            continue
        p, r = a[i], b[i] - a[i]
        q, s = a[js], b[js] - a[js]
        rxs = r[0] * (s[:, 1]) - r[1] * (s[:, 0])
        qp = q - p
        t_num = qp[:, 0] * s[:, 1] - qp[:, 1] * s[:, 0]
        u_num = qp[:, 0] * r[1] - qp[:, 1] * r[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = t_num / rxs
            u = u_num / rxs
        hit = (
            (rxs != 0)
            & (t > 1e-12) & (t < 1 - 1e-12)
            & (u > 1e-12) & (u < 1 - 1e-12)
        )
        if bool(hit.any()):
            return True
    return False


def st_isSimple(geom):
    """No self-intersection (points/multipoints are always simple;
    linestrings and polygon rings are checked pairwise)."""

    def one(g):
        if isinstance(g, (Point, MultiPoint)):
            return True
        if isinstance(g, LineString):
            return not _segments_self_intersect(np.asarray(g.coords))
        if isinstance(g, MultiLineString):
            return all(one(l) for l in g.lines)
        if isinstance(g, Polygon):
            return not any(
                _segments_self_intersect(np.asarray(r)) for r in g.rings()
            )
        if isinstance(g, MultiPolygon):
            return all(one(p) for p in g.polygons)
        return True

    out = _scalar_or_col(geom, one)
    return np.asarray(out, dtype=bool) if not isinstance(out, bool) else out


def st_isValid(geom):
    """Structural validity: rings closed with >= 4 points and simple
    (no self-intersection); lines need >= 2 points. A light version of
    the reference's JTS IsValidOp (no nested-hole topology checks)."""

    def one(g):
        if isinstance(g, Polygon):
            for r in g.rings():
                c = np.asarray(r)
                if len(c) < 4 or not np.array_equal(c[0], c[-1]):
                    return False
                if _segments_self_intersect(c):
                    return False
            return True
        if isinstance(g, MultiPolygon):
            return all(one(p) for p in g.polygons)
        if isinstance(g, LineString):
            return len(g.coords) >= 2
        if isinstance(g, MultiLineString):
            return all(len(l.coords) >= 2 for l in g.lines)
        return True

    out = _scalar_or_col(geom, one)
    return np.asarray(out, dtype=bool) if not isinstance(out, bool) else out


# -- spheroid measures (WGS84 Vincenty) --------------------------------------

_WGS84_A = 6_378_137.0
_WGS84_B = 6_356_752.314245
_WGS84_F = 1.0 / 298.257223563


def _vincenty_m(lon1, lat1, lon2, lat2) -> np.ndarray:
    """Vectorized Vincenty inverse distance (meters) on WGS84; falls back
    to the haversine-sphere value for the rare non-converging antipodal
    pairs."""
    lon1, lat1, lon2, lat2 = (
        np.asarray(v, np.float64) for v in (lon1, lat1, lon2, lat2)
    )
    U1 = np.arctan((1 - _WGS84_F) * np.tan(np.radians(lat1)))
    U2 = np.arctan((1 - _WGS84_F) * np.tan(np.radians(lat2)))
    L = np.radians(lon2 - lon1)
    lam = L.copy()
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)
    sin_sig = cos_sig = sig = cos_sq_al = cos2sm = np.zeros_like(L)
    lam_prev = lam
    for _ in range(24):
        lam_prev = lam
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        sin_sig = np.sqrt(
            (cosU2 * sin_lam) ** 2
            + (cosU1 * sinU2 - sinU1 * cosU2 * cos_lam) ** 2
        )
        cos_sig = sinU1 * sinU2 + cosU1 * cosU2 * cos_lam
        sig = np.arctan2(sin_sig, cos_sig)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_al = np.where(
                sin_sig != 0, cosU1 * cosU2 * sin_lam / sin_sig, 0.0
            )
        cos_sq_al = 1 - sin_al**2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos2sm = np.where(
                cos_sq_al != 0,
                cos_sig - 2 * sinU1 * sinU2 / np.where(
                    cos_sq_al == 0, 1.0, cos_sq_al
                ),
                0.0,
            )
        C = _WGS84_F / 16 * cos_sq_al * (
            4 + _WGS84_F * (4 - 3 * cos_sq_al)
        )
        lam = L + (1 - C) * _WGS84_F * sin_al * (
            sig
            + C * sin_sig * (cos2sm + C * cos_sig * (-1 + 2 * cos2sm**2))
        )
    u_sq = cos_sq_al * (_WGS84_A**2 - _WGS84_B**2) / _WGS84_B**2
    A = 1 + u_sq / 16384 * (
        4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq))
    )
    B = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    d_sig = B * sin_sig * (
        cos2sm
        + B / 4 * (
            cos_sig * (-1 + 2 * cos2sm**2)
            - B / 6 * cos2sm * (-3 + 4 * sin_sig**2) * (-3 + 4 * cos2sm**2)
        )
    )
    out = _WGS84_B * A * (sig - d_sig)
    # Vincenty's lambda iteration fails to converge for near-antipodal
    # pairs (it oscillates); substitute the haversine value on the WGS84
    # mean-radius sphere there, as the docstring promises. 1e-12 rad of
    # lambda movement ~ 6 um on the equator.
    converged = np.abs(lam - lam_prev) < 1e-12
    if not np.all(converged):
        r_mean = (2 * _WGS84_A + _WGS84_B) / 3
        p1, p2 = np.radians(lat1), np.radians(lat2)
        dp, dl = p2 - p1, np.radians(lon2 - lon1)
        h = (
            np.sin(dp / 2) ** 2
            + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
        )
        hav = 2 * r_mean * np.arcsin(np.minimum(1.0, np.sqrt(h)))
        out = np.where(converged, out, hav)
    # coincident points: exactly zero (the iteration above is stable there)
    return np.where((lon1 == lon2) & (lat1 == lat2), 0.0, out)


def st_distanceSpheroid(a, b):
    """Point-to-point distance in meters on the WGS84 spheroid (Vincenty
    inverse; the reference delegates to GeodeticCalculator)."""

    def coords(g):
        if isinstance(g, Point):
            return np.array([[g.x, g.y]])
        if _is_point_col(g):
            return g
        return np.stack([[p.x, p.y] for p in g])

    ca, cb = coords(a), coords(b)
    n = max(len(ca), len(cb))
    ca = np.broadcast_to(ca, (n, 2))
    cb = np.broadcast_to(cb, (n, 2))
    d = _vincenty_m(ca[:, 0], ca[:, 1], cb[:, 0], cb[:, 1])
    if isinstance(a, Point) and isinstance(b, Point):
        return float(d[0])
    return d


def st_lengthSpheroid(geom):
    """Path length in meters on the WGS84 spheroid (per-segment Vincenty,
    summed)."""

    def one(g):
        segs = _segments_of(g)
        if len(segs) == 0:
            return 0.0
        return float(
            _vincenty_m(
                segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
            ).sum()
        )

    return _scalar_or_col(geom, one)


# -- affine transforms -------------------------------------------------------


def st_rotate(geom, angle_rad: float):
    """Rotate about the origin by ``angle_rad`` (counter-clockwise)."""
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    rot = np.array([[c, s], [-s, c]])

    def one(g):
        return _map_coords(g, lambda xy: xy @ rot)

    return _scalar_or_col(geom, one)


def st_scale(geom, xf: float, yf: float):
    """Scale about the origin by (xf, yf)."""
    f = np.array([xf, yf], np.float64)

    def one(g):
        return _map_coords(g, lambda xy: xy * f)

    return _scalar_or_col(geom, one)


# -- CRS transforms and bearings ---------------------------------------------

_WEB_MERCATOR_R = 6_378_137.0
_MERC_MAX_LAT = 85.051128779806604  # atan(sinh(pi)) in degrees


def _merc_fwd(xy: np.ndarray) -> np.ndarray:
    lon = np.radians(xy[:, 0])
    lat = np.radians(np.clip(xy[:, 1], -_MERC_MAX_LAT, _MERC_MAX_LAT))
    return np.stack(
        [
            _WEB_MERCATOR_R * lon,
            _WEB_MERCATOR_R * np.log(np.tan(np.pi / 4 + lat / 2)),
        ],
        axis=1,
    )


def _merc_inv(xy: np.ndarray) -> np.ndarray:
    lon = np.degrees(xy[:, 0] / _WEB_MERCATOR_R)
    lat = np.degrees(
        2 * np.arctan(np.exp(xy[:, 1] / _WEB_MERCATOR_R)) - np.pi / 2
    )
    return np.stack([lon, lat], axis=1)


# -- WGS84 UTM (transverse Mercator, Krueger series; ref GeoTools reaches
# these through PROJ — here they are the exact flattening-series forms
# (Karney 2011), accurate to sub-mm inside a zone) ---------------------------

_UTM_K0 = 0.9996
_UTM_FE = 500_000.0
_UTM_FN_SOUTH = 10_000_000.0
_TM_N = _WGS84_F / (2.0 - _WGS84_F)


def _tm_consts():
    n = _TM_N
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    A = _WGS84_A / (1 + n) * (1 + n2 / 4 + n4 / 64 + n6 / 256)
    alpha = (
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180
        - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630
        - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880
        + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    )
    beta = (
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512
        + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105
        - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480
        + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    )
    return A, alpha, beta


_TM_A, _TM_ALPHA, _TM_BETA = _tm_consts()
_TM_E = np.sqrt(_WGS84_F * (2.0 - _WGS84_F))  # first eccentricity


def _utm_fwd(xy: np.ndarray, zone: int, south: bool) -> np.ndarray:
    lon0 = np.radians(zone * 6.0 - 183.0)
    lam = np.radians(xy[:, 0]) - lon0
    # wrap into (-pi, pi] so e.g. lon 179 vs zone 60 (177E) is a small
    # negative offset, then enforce the series' validity domain: beyond
    # ~+-45 deg from the central meridian the Krueger series diverges
    # (arctanh blows up at 90 deg) — raise, never misproject silently
    lam = np.mod(lam + np.pi, 2 * np.pi) - np.pi
    if len(lam) and float(np.abs(lam).max()) > np.radians(45.0):
        raise ValueError(
            f"point(s) more than 45 deg of longitude from UTM zone "
            f"{zone}'s central meridian: outside the projection's "
            "validity domain"
        )
    phi = np.radians(xy[:, 1])
    e = _TM_E
    s = np.sin(phi)
    t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
    xi = np.arctan2(t, np.cos(lam))
    eta = np.arctanh(np.sin(lam) / np.sqrt(1 + t * t))
    x, y = eta.copy(), xi.copy()
    for j, a in enumerate(_TM_ALPHA, start=1):
        y += a * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        x += a * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    E = _UTM_FE + _UTM_K0 * _TM_A * x
    N = (_UTM_FN_SOUTH if south else 0.0) + _UTM_K0 * _TM_A * y
    return np.stack([E, N], axis=1)


def _utm_inv(xy: np.ndarray, zone: int, south: bool) -> np.ndarray:
    lon0 = np.radians(zone * 6.0 - 183.0)
    xi = (xy[:, 1] - (_UTM_FN_SOUTH if south else 0.0)) / (
        _UTM_K0 * _TM_A
    )
    eta = (xy[:, 0] - _UTM_FE) / (_UTM_K0 * _TM_A)
    xi_p, eta_p = xi.copy(), eta.copy()
    for j, b in enumerate(_TM_BETA, start=1):
        xi_p -= b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p -= b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    sh, c = np.sinh(eta_p), np.cos(xi_p)
    lam = np.arctan2(sh, c)
    tau_p = np.sin(xi_p) / np.sqrt(sh * sh + c * c)
    # invert the conformal-latitude relation by Newton on tau = tan(phi)
    # (Karney's method; 3 iterations reach float64 round-off)
    e = _TM_E
    tau = tau_p / (1.0 - e * e)
    for _ in range(3):
        sig = np.sinh(
            e * np.arctanh(e * tau / np.sqrt(1 + tau * tau))
        )
        f_tau = (
            tau * np.sqrt(1 + sig * sig)
            - sig * np.sqrt(1 + tau * tau)
            - tau_p
        )
        d_tau = (
            np.sqrt((1 + sig * sig) * (1 + tau * tau))
            - sig * tau
        ) * (1 - e * e) / (1 + (1 - e * e) * tau * tau) * np.sqrt(
            1 + tau * tau
        )
        tau = tau - f_tau / d_tau
    phi = np.arctan(tau)
    # wrap into (-180, 180]: a zone near the antimeridian otherwise
    # returns e.g. lon 185 and breaks the 4326 roundtrip
    lon = np.degrees(lam + lon0)
    lon = np.mod(lon + 180.0, 360.0) - 180.0
    return np.stack([lon, np.degrees(phi)], axis=1)


def st_transform(geom, from_crs: str, to_crs: str):
    """Reproject between EPSG:4326 (lon/lat degrees), EPSG:3857
    (spherical web mercator meters — every tiled map client), and the
    WGS84 UTM zones (EPSG:326xx north / 327xx south, exact Krueger
    flattening series). Other CRS raise loudly (this framework indexes
    in 4326; full PROJ-style pipelines are out of scope). Mercator
    latitudes clamp to the tiling domain (±85.05113°); pairs that
    involve both 3857 and UTM compose through 4326."""

    def norm(c):
        c = str(c).upper().replace("EPSG:", "")
        if c in ("4326", "CRS84"):
            return "4326"
        if c in ("3857", "900913", "102100"):
            return "3857"
        if len(c) == 5 and c[:3] in ("326", "327") and c[3:].isdigit():
            zone = int(c[3:])
            if 1 <= zone <= 60:
                return c
        raise ValueError(
            f"unsupported CRS {c!r} (4326, 3857, UTM 326xx/327xx only)"
        )

    f, t = norm(from_crs), norm(to_crs)
    if f == t:
        return geom

    def step(code, forward):
        """4326 -> code when forward else code -> 4326."""
        if code == "3857":
            return _merc_fwd if forward else _merc_inv
        zone, south = int(code[3:]), code[:3] == "327"
        if forward:
            return lambda xy: _utm_fwd(xy, zone, south)
        return lambda xy: _utm_inv(xy, zone, south)

    chain = []
    if f != "4326":
        chain.append(step(f, forward=False))
    if t != "4326":
        chain.append(step(t, forward=True))

    def fn(xy):
        for s in chain:
            xy = s(xy)
        return xy

    if _is_point_col(geom):
        return fn(np.asarray(geom, np.float64))

    def one(g):
        return _map_coords(g, lambda xy: fn(np.atleast_2d(xy)))

    return _scalar_or_col(geom, one)


def st_azimuth(a, b):
    """Bearing from point a to point b in radians clockwise from north,
    in [0, 2π) — planar on lon/lat (the reference's JTS Angle-based
    azimuth), NaN for coincident points."""

    def coords(g):
        if isinstance(g, Point):
            return np.array([[g.x, g.y]])
        if _is_point_col(g):
            return np.asarray(g, np.float64)
        return np.stack([[p.x, p.y] for p in g])

    ca, cb = coords(a), coords(b)
    n = max(len(ca), len(cb))
    ca = np.broadcast_to(ca, (n, 2))
    cb = np.broadcast_to(cb, (n, 2))
    dx = cb[:, 0] - ca[:, 0]
    dy = cb[:, 1] - ca[:, 1]
    az = np.mod(np.arctan2(dx, dy), 2 * np.pi)
    az = np.where((dx == 0) & (dy == 0), np.nan, az)
    if isinstance(a, Point) and isinstance(b, Point):
        return float(az[0])
    return az


# -- polygon boolean ops (geom/clip.py Greiner-Hormann engine) ---------------


def _boolean_op(a, b, fn):
    if isinstance(a, Geometry) and isinstance(b, Geometry):
        return fn(a, b)
    if isinstance(a, Geometry):
        return np.array([fn(a, g) for g in b], dtype=object)
    if isinstance(b, Geometry):
        return np.array([fn(g, b) for g in a], dtype=object)
    return np.array([fn(x, y) for x, y in zip(a, b)], dtype=object)


def st_intersection(a, b):
    """Polygon ∩ polygon (holes supported on either side; see
    geom/clip.py for the contract)."""
    from geomesa_tpu_torch.geom.clip import polygon_intersection

    return _boolean_op(a, b, polygon_intersection)


def st_union(a, b):
    from geomesa_tpu_torch.geom.clip import polygon_union

    return _boolean_op(a, b, polygon_union)


def st_difference(a, b):
    from geomesa_tpu_torch.geom.clip import polygon_difference

    return _boolean_op(a, b, polygon_difference)


def st_symDifference(a, b):
    from geomesa_tpu_torch.geom.clip import polygon_sym_difference

    return _boolean_op(a, b, polygon_sym_difference)


def st_aggregateIntersection(geoms):
    """Fold ∩ over a geometry column (ref aggregate UDF)."""
    from geomesa_tpu_torch.geom.clip import polygon_intersection

    geoms = list(geoms)
    if not geoms:
        return MultiPolygon(())
    acc = geoms[0]
    for g in geoms[1:]:
        acc = polygon_intersection(acc, g)
    return acc


def st_aggregateUnion(geoms):
    """Fold ∪ over a geometry column (ref aggregate UDF)."""
    from geomesa_tpu_torch.geom.clip import polygon_union

    geoms = list(geoms)
    if not geoms:
        return MultiPolygon(())
    acc = geoms[0]
    for g in geoms[1:]:
        acc = polygon_union(acc, g)
    return acc


# -- registry ----------------------------------------------------------------

FUNCTIONS = {
    name: fn
    for name, fn in list(globals().items())
    if name.startswith("st_") and callable(fn)
}

__all__ = sorted(FUNCTIONS)
