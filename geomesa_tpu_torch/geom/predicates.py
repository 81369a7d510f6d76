"""Vectorized host geometry predicates.

Copy of ``geomesa_tpu/geom/predicates.py`` without its JAX twin of the
point-in-polygon test (the card runs that test in the filter-scan kernel):
the crossing-number containment test over packed edge lists, segment
intersection, ``geometry_intersects``/``geometry_within`` (the exact host
residual of the envelope prefilter), and the DE-9IM-lite relation algebra
(touches, crosses, overlaps, relate and pattern matching), and the
point-to-segment distances of proximity search. Boundary
behavior: points exactly on a horizontal-crossing vertex follow the
half-open rule (a vertex counts for the edge whose y-interval is
[min, max)); points on edges may test either way at float precision --
the caveat of JTS's RayCrossingCounter fast path.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geom.base import (
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)


def polygon_edges(rings) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack closed rings into edge arrays (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = [], [], [], []
    for ring in rings:
        r = np.asarray(ring, dtype=np.float64)
        a = r[:-1]
        b = r[1:]
        x1.append(a[:, 0])
        y1.append(a[:, 1])
        x2.append(b[:, 0])
        y2.append(b[:, 1])
    return (
        np.concatenate(x1),
        np.concatenate(y1),
        np.concatenate(x2),
        np.concatenate(y2),
    )


def points_in_polygon(px, py, rings) -> np.ndarray:
    """Crossing-number containment for (n,) point arrays against a polygon
    given as closed rings (shell + holes: odd crossings = inside)."""
    x1, y1, x2, y2 = polygon_edges(rings)
    px = np.asarray(px, dtype=np.float64)[:, None]
    py = np.asarray(py, dtype=np.float64)[:, None]
    # edge straddles the horizontal ray (half-open to dodge vertex double count)
    straddle = (y1[None, :] > py) != (y2[None, :] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
    crossing = straddle & (px < xint)
    return crossing.sum(axis=1) % 2 == 1


def _segments_of(geom) -> "np.ndarray | None":
    """(m, 4) [x1, y1, x2, y2] segment array for a line/polygon geometry."""
    if isinstance(geom, LineString):
        c = geom.coords
        return np.concatenate([c[:-1], c[1:]], axis=1)
    if isinstance(geom, (Polygon, MultiPolygon)):
        x1, y1, x2, y2 = polygon_edges(geom.rings())
        return np.stack([x1, y1, x2, y2], axis=1)
    if isinstance(geom, MultiLineString):
        return np.concatenate([_segments_of(l) for l in geom.lines], axis=0)
    return None


def distance_segments(g) -> np.ndarray:
    """(m, 4) [x0, y0, x1, y1] edges of any geometry (rings include holes);
    points yield zero-length segments, so one distance formula covers
    every input. Copy of ``_segments_of`` in ``geomesa_tpu/sql/functions.py``."""
    segs = _segments_of(g)
    if segs is not None:
        return segs
    va = np.array([[p.x, p.y] for p in _points_of(g)], np.float64).reshape(-1, 2)
    return np.concatenate([va, va], axis=1)


def pt_seg_project(pts: np.ndarray, segs: np.ndarray):
    """Clamped projection of each point onto each segment. ``pts`` is
    (n, 2), ``segs`` is (m, 4) as [x0, y0, x1, y1]. Returns ``(t, dist2)``
    with shape (n, m): the clamped parameter along each segment and the
    squared point-to-segment distance. Copy of ``pt_seg_project`` in
    ``geomesa_tpu/sql/functions.py``."""
    p = pts[:, None, :]
    a = segs[None, :, 0:2]
    d = segs[None, :, 2:4] - a
    len2 = (d**2).sum(-1)
    t = ((p - a) * d).sum(-1) / np.where(len2 == 0, 1.0, len2)
    t = np.clip(np.where(len2 == 0, 0.0, t), 0.0, 1.0)
    near = a + t[..., None] * d
    return t, ((p - near) ** 2).sum(-1)


def _expand_pairs(sa: np.ndarray, sb: np.ndarray):
    """All (m*k, 4) segment pairs of sa x sb, or None when either is
    empty -- the one place the pairwise expansion lives."""
    if sa is None or sb is None or len(sa) == 0 or len(sb) == 0:
        return None
    m, k = len(sa), len(sb)
    return np.repeat(sa, k, axis=0), np.tile(sb, (m, 1))


def _cross(ox, oy, px_, py_, qx, qy):
    """Cross product of (p - o) x (q - o): the single orientation
    primitive every predicate shares (any robustness/tolerance fix
    happens here)."""
    return (px_ - ox) * (qy - oy) - (py_ - oy) * (qx - ox)


def _orient(ox, oy, px_, py_, qx, qy):
    return np.sign(_cross(ox, oy, px_, py_, qx, qy))


def _any_segments_cross(sa: np.ndarray, sb: np.ndarray) -> bool:
    """Do any segments of (m,4) array sa intersect any of (k,4) sb."""
    pairs = _expand_pairs(sa, sb)
    if pairs is None:
        return False
    A, B = pairs
    hits = segments_intersect(
        A[:, 0], A[:, 1], A[:, 2], A[:, 3], B[:, 0], B[:, 1], B[:, 2], B[:, 3]
    )
    return bool(hits.any())


def _poly_contains_point(geom, x: float, y: float) -> bool:
    if isinstance(geom, Polygon):
        return bool(points_in_polygon(np.array([x]), np.array([y]), geom.rings())[0])
    if isinstance(geom, MultiPolygon):
        return any(_poly_contains_point(p, x, y) for p in geom.polygons)
    return False


def geometry_intersects(a, b) -> bool:
    """Exact intersects for the supported geometry subset (host-side
    residual; the device path prefilters with bboxes).

    Handles Point / LineString / Polygon / Multi* pairs via: bbox reject,
    any-segments-cross, or either containing a vertex of the other.
    Boundary behavior at float precision matches the crossing-number caveat
    in the module docstring (JTS-robustness is out of scope).
    """
    if not a.envelope.intersects(b.envelope):
        return False
    if isinstance(a, MultiPoint):
        return any(geometry_intersects(p, b) for p in a.points)
    if isinstance(b, MultiPoint):
        return any(geometry_intersects(a, p) for p in b.points)
    if isinstance(a, Point) and isinstance(b, Point):
        return a.x == b.x and a.y == b.y
    if isinstance(a, Point) or isinstance(b, Point):
        pt, other = (a, b) if isinstance(a, Point) else (b, a)
        if isinstance(other, (Polygon, MultiPolygon)):
            if _poly_contains_point(other, pt.x, pt.y):
                return True
        return _on_any_segment(pt.x, pt.y, _segments_of(other))
    sa, sb = _segments_of(a), _segments_of(b)
    if _any_segments_cross(sa, sb):
        return True
    # containment without boundary crossing: a component lies entirely
    # inside the other geometry -- test one vertex of EVERY component (a
    # multi-part geometry can have one far part and one contained part)
    if isinstance(a, (Polygon, MultiPolygon)) and any(
        _poly_contains_point(a, float(vx), float(vy))
        for vx, vy in _component_vertices(b)
    ):
        return True
    if isinstance(b, (Polygon, MultiPolygon)) and any(
        _poly_contains_point(b, float(vx), float(vy))
        for vx, vy in _component_vertices(a)
    ):
        return True
    return False


def _component_vertices(geom):
    """One representative vertex per connected component."""
    if isinstance(geom, LineString):
        yield geom.coords[0, 0], geom.coords[0, 1]
    elif isinstance(geom, Polygon):
        yield geom.shell[0, 0], geom.shell[0, 1]
    elif isinstance(geom, MultiPolygon):
        for p in geom.polygons:
            yield p.shell[0, 0], p.shell[0, 1]
    elif isinstance(geom, MultiLineString):
        for l in geom.lines:
            yield l.coords[0, 0], l.coords[0, 1]


def geometry_within(inner, outer) -> bool:
    """Is ``inner`` entirely within ``outer`` (interior-contained, boundary
    tolerance per the crossing-number caveat)? Supported for polygon/line/
    point inner vs polygon outer."""
    if not isinstance(outer, (Polygon, MultiPolygon)):
        return False
    if isinstance(inner, Point):
        return _poly_contains_point(outer, inner.x, inner.y)
    if not outer.envelope.contains_env(inner.envelope):
        return False
    si = _segments_of(inner)
    so = _segments_of(outer)
    if si is None:
        return False
    if _any_segments_cross(si, so):
        return False
    # no boundary crossings: containment decided per component vertex
    return all(
        _poly_contains_point(outer, float(vx), float(vy))
        for vx, vy in _component_vertices(inner)
    )


def segments_intersect(ax, ay, bx, by, cx, cy, dx, dy) -> np.ndarray:
    """Vectorized proper/improper segment intersection AB vs CD (orientation
    sign tests, inclusive of touching endpoints)."""
    d1 = _orient(cx, cy, dx, dy, ax, ay)
    d2 = _orient(cx, cy, dx, dy, bx, by)
    d3 = _orient(ax, ay, bx, by, cx, cy)
    d4 = _orient(ax, ay, bx, by, dx, dy)
    proper = (d1 * d2 < 0) & (d3 * d4 < 0)

    def on_seg(ox, oy, px_, py_, qx, qy):
        return (
            (_orient(ox, oy, px_, py_, qx, qy) == 0)
            & (np.minimum(ox, px_) <= qx)
            & (qx <= np.maximum(ox, px_))
            & (np.minimum(oy, py_) <= qy)
            & (qy <= np.maximum(oy, py_))
        )

    touch = (
        on_seg(cx, cy, dx, dy, ax, ay)
        | on_seg(cx, cy, dx, dy, bx, by)
        | on_seg(ax, ay, bx, by, cx, cy)
        | on_seg(ax, ay, bx, by, dx, dy)
    )
    return proper | touch


# -- DE-9IM-lite relation algebra --------------------------------------------
# (ref: geomesa-spark SpatialRelationFunctions + JTS RelateOp [UNVERIFIED -
# empty reference mount]). Exact for the common cases (shared edges built
# from the same coordinates, proper crossings, containment); the documented
# lite caveats: float-precision boundary contact is measure-zero fuzzy, and
# a crossing that passes exactly through interior VERTICES of both
# polylines (orientation tests all zero) is classified as touching.
# Line-in-line coverage refines its samples at the covering line's
# component endpoints, so gaps between collinear components are detected.


def geometry_dimension(g) -> int:
    """Topological dimension: 0 points, 1 lines, 2 areas."""
    if isinstance(g, (Point, MultiPoint)):
        return 0
    if isinstance(g, (LineString, MultiLineString)):
        return 1
    if isinstance(g, (Polygon, MultiPolygon)):
        return 2
    raise TypeError(f"unsupported geometry {type(g).__name__}")


def _points_of(g):
    if isinstance(g, Point):
        return [g]
    if isinstance(g, MultiPoint):
        return list(g.points)
    return []


def _polygons_of(g):
    if isinstance(g, Polygon):
        return [g]
    if isinstance(g, MultiPolygon):
        return list(g.polygons)
    return []


def _line_components(g):
    if isinstance(g, LineString):
        return [g]
    if isinstance(g, MultiLineString):
        return list(g.lines)
    return []


def _on_any_segment(x: float, y: float, segs) -> bool:
    if segs is None or len(segs) == 0:
        return False
    px = np.full(len(segs), x)
    py = np.full(len(segs), y)
    return bool(
        segments_intersect(
            px, py, px, py, segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
        ).any()
    )


def _strict_in_area(area, x: float, y: float) -> bool:
    """Strictly inside (interior): odd-crossing inside and not on a ring."""
    if _on_any_segment(x, y, _segments_of(area)):
        return False
    return _poly_contains_point(area, x, y)


def _in_or_on_area(area, x: float, y: float) -> bool:
    return _poly_contains_point(area, x, y) or _on_any_segment(
        x, y, _segments_of(area)
    )


def interior_point(poly) -> "tuple[float, float]":
    """A point strictly inside the polygon (mid-scanline construction:
    works for concave shells and respects holes)."""
    ys = np.unique(
        np.concatenate([np.asarray(r)[:, 1] for r in poly.rings()])
    )
    candidates = (ys[:-1] + ys[1:]) / 2.0 if len(ys) > 1 else np.array([])
    segs = _segments_of(poly)
    for yc in candidates:
        y1, y2 = segs[:, 1], segs[:, 3]
        straddle = (y1 > yc) != (y2 > yc)
        if not straddle.any():
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            xs = segs[:, 0] + (yc - y1) * (segs[:, 2] - segs[:, 0]) / (
                y2 - y1
            )
        xs = np.sort(xs[straddle])
        for x1, x2 in zip(xs[:-1], xs[1:]):
            xm = (float(x1) + float(x2)) / 2.0
            if _strict_in_area(poly, xm, yc):
                return xm, float(yc)
    # degenerate (zero-area) polygon: fall back to the first vertex
    return float(poly.shell[0, 0]), float(poly.shell[0, 1])


def _proper_cross_any(sa, sb) -> bool:
    """Any strictly-proper segment crossing (interiors pass through)."""
    pairs = _expand_pairs(sa, sb)
    if pairs is None:
        return False
    A, B = pairs
    d1 = _orient(B[:, 0], B[:, 1], B[:, 2], B[:, 3], A[:, 0], A[:, 1])
    d2 = _orient(B[:, 0], B[:, 1], B[:, 2], B[:, 3], A[:, 2], A[:, 3])
    d3 = _orient(A[:, 0], A[:, 1], A[:, 2], A[:, 3], B[:, 0], B[:, 1])
    d4 = _orient(A[:, 0], A[:, 1], A[:, 2], A[:, 3], B[:, 2], B[:, 3])
    return bool(((d1 * d2 < 0) & (d3 * d4 < 0)).any())


def _collinear_overlap_any(sa, sb) -> bool:
    """Any pair of collinear segments sharing positive-length extent."""
    pairs = _expand_pairs(sa, sb)
    if pairs is None:
        return False
    A, B = pairs
    col = (
        (_cross(A[:, 0], A[:, 1], A[:, 2], A[:, 3], B[:, 0], B[:, 1]) == 0)
        & (_cross(A[:, 0], A[:, 1], A[:, 2], A[:, 3], B[:, 2], B[:, 3]) == 0)
    )
    # project onto the dominant axis of A and require positive overlap
    dx = np.abs(A[:, 2] - A[:, 0])
    dy = np.abs(A[:, 3] - A[:, 1])
    use_x = dx >= dy
    a_lo = np.where(use_x, np.minimum(A[:, 0], A[:, 2]), np.minimum(A[:, 1], A[:, 3]))
    a_hi = np.where(use_x, np.maximum(A[:, 0], A[:, 2]), np.maximum(A[:, 1], A[:, 3]))
    b_lo = np.where(use_x, np.minimum(B[:, 0], B[:, 2]), np.minimum(B[:, 1], B[:, 3]))
    b_hi = np.where(use_x, np.maximum(B[:, 0], B[:, 2]), np.maximum(B[:, 1], B[:, 3]))
    overlap = np.minimum(a_hi, b_hi) - np.maximum(a_lo, b_lo)
    return bool((col & (overlap > 0)).any())


def _line_boundary_points(g):
    """Boundary of a line = the endpoints of its open components (a closed
    ring has no boundary). Lite: interior vertices of even degree across
    components are not cancelled (mod-2 rule applied per component only)."""
    pts = []
    for comp in _line_components(g):
        c = comp.coords
        if len(c) and not (c[0, 0] == c[-1, 0] and c[0, 1] == c[-1, 1]):
            pts.append((float(c[0, 0]), float(c[0, 1])))
            pts.append((float(c[-1, 0]), float(c[-1, 1])))
    return pts


def _line_sample_points(g):
    """Interior samples of a polyline: segment midpoints + interior
    vertices (endpoints excluded -- they are boundary)."""
    out = []
    boundary = set(_line_boundary_points(g))
    for comp in _line_components(g):
        c = comp.coords
        mids = (c[:-1] + c[1:]) / 2.0
        out.extend((float(x), float(y)) for x, y in mids)
        out.extend(
            (float(x), float(y))
            for x, y in c
            if (float(x), float(y)) not in boundary
        )
    return out


def _line_interior_intersects_area(line, area) -> bool:
    sl = _segments_of(line)
    if _proper_cross_any(sl, _segments_of(area)):
        return True
    return any(_strict_in_area(area, x, y) for x, y in _line_sample_points(line))


def _covered(a, b) -> bool:
    """Is a within the closure of b (lite: sample-point based)."""
    da, db = geometry_dimension(a), geometry_dimension(b)
    if da > db:
        return False  # higher dim can't be covered by lower
    if da == 0:
        return all(geometry_intersects(p, b) for p in _points_of(a))
    if da == 1:
        sa = _segments_of(a)
        samples = _line_sample_points(a) + _line_boundary_points(a)
        if db == 1:
            sb = _segments_of(b)
            # refine: cut every segment of a at b's vertices that lie on
            # it, and sample the cut midpoints -- a gap in b always starts
            # and ends at b vertices, so midpoint samples between
            # consecutive cuts expose it (plain midpoints would not)
            bverts = np.unique(
                np.concatenate([sb[:, :2], sb[:, 2:]], axis=0), axis=0
            )
            for x1, y1, x2, y2 in sa:
                ts = [0.0, 1.0]
                dx, dy = x2 - x1, y2 - y1
                L2 = dx * dx + dy * dy
                if L2 == 0:
                    continue
                for vx, vy in bverts:
                    if (vx - x1) * dy - (vy - y1) * dx != 0:
                        continue  # not on this segment's line
                    t = ((vx - x1) * dx + (vy - y1) * dy) / L2
                    if 0.0 < t < 1.0:
                        ts.append(float(t))
                ts.sort()
                for t0, t1 in zip(ts[:-1], ts[1:]):
                    tm = (t0 + t1) / 2.0
                    samples.append((x1 + tm * dx, y1 + tm * dy))
            return all(_on_any_segment(x, y, sb) for x, y in samples)
        # line in area: every sample in-or-on, and no proper escape
        # through the boundary
        if _proper_cross_any(sa, _segments_of(b)):
            return False
        return all(_in_or_on_area(b, x, y) for x, y in samples)
    # area in area
    if _proper_cross_any(_segments_of(a), _segments_of(b)):
        return False
    for vx, vy in np.concatenate([r[:-1] for r in a.rings()]):
        if not _in_or_on_area(b, float(vx), float(vy)):
            return False
    return all(
        _in_or_on_area(b, *interior_point(p)) for p in _polygons_of(a)
    )


def _area_interiors_intersect(a, b) -> bool:
    if _proper_cross_any(_segments_of(a), _segments_of(b)):
        return True
    for p in _polygons_of(a):
        if _strict_in_area(b, *interior_point(p)):
            return True
    for p in _polygons_of(b):
        if _strict_in_area(a, *interior_point(p)):
            return True
    return False


def _interiors_intersect(a, b) -> bool:
    """Do the interiors of a and b share a point (the II cell of DE-9IM)?
    For a point geometry the interior is the point itself."""
    da, db = geometry_dimension(a), geometry_dimension(b)
    if da > db:
        return _interiors_intersect(b, a)
    if da == 0:
        if db == 0:
            bpts = {(p.x, p.y) for p in _points_of(b)}
            return any((p.x, p.y) in bpts for p in _points_of(a))
        if db == 1:
            boundary = set(_line_boundary_points(b))
            return any(
                (p.x, p.y) not in boundary
                and _on_any_segment(p.x, p.y, _segments_of(b))
                for p in _points_of(a)
            )
        return any(_strict_in_area(b, p.x, p.y) for p in _points_of(a))
    if da == 1:
        if db == 1:
            sa, sb = _segments_of(a), _segments_of(b)
            if _proper_cross_any(sa, sb) or _collinear_overlap_any(sa, sb):
                return True
            # an interior sample of one lying on the interior of the other
            # (both directions: the contact point may be a vertex of either)
            bb = set(_line_boundary_points(b))
            if any(
                _on_any_segment(x, y, sb) and (x, y) not in bb
                for x, y in _line_sample_points(a)
            ):
                return True
            ba = set(_line_boundary_points(a))
            return any(
                _on_any_segment(x, y, sa) and (x, y) not in ba
                for x, y in _line_sample_points(b)
            )
        return _line_interior_intersects_area(a, b)
    return _area_interiors_intersect(a, b)


def geometry_touches(a, b) -> bool:
    """Geometries intersect but their interiors do not (OGC touches).
    Always False for point/point pairs."""
    if geometry_dimension(a) == 0 and geometry_dimension(b) == 0:
        return False
    if not geometry_intersects(a, b):
        return False
    return not _interiors_intersect(a, b)


def geometry_crosses(a, b) -> bool:
    """OGC crosses: interiors intersect in a lower dimension than the
    geometries' max, and each geometry has parts outside the other.
    Defined for point/line, point/area, line/area, line/line."""
    da, db = geometry_dimension(a), geometry_dimension(b)
    if da > db:
        return geometry_crosses(b, a)
    if da == 0 and db == 0:
        return False
    if da == 0:
        pts = _points_of(a)
        if len(pts) < 2:
            return False  # a single point cannot also have an exterior part
        inside = _interiors_intersect(a, b)
        outside = any(not geometry_intersects(p, b) for p in pts)
        return inside and outside
    if da == 1 and db == 1:
        sa, sb = _segments_of(a), _segments_of(b)
        return _proper_cross_any(sa, sb) and not _collinear_overlap_any(
            sa, sb
        )
    if da == 1 and db == 2:
        if not _line_interior_intersects_area(a, b):
            return False
        samples = _line_sample_points(a) + _line_boundary_points(a)
        return any(not _in_or_on_area(b, x, y) for x, y in samples)
    return False  # area/area never crosses


def geometry_overlaps(a, b) -> bool:
    """OGC overlaps: same dimension, interiors intersect with that same
    dimension, and neither is covered by the other."""
    da, db = geometry_dimension(a), geometry_dimension(b)
    if da != db:
        return False
    if da == 0:
        apts = {(p.x, p.y) for p in _points_of(a)}
        bpts = {(p.x, p.y) for p in _points_of(b)}
        return bool(apts & bpts) and bool(apts - bpts) and bool(bpts - apts)
    if da == 1:
        sa, sb = _segments_of(a), _segments_of(b)
        if not _collinear_overlap_any(sa, sb):
            return False
        return not _covered(a, b) and not _covered(b, a)
    if not _area_interiors_intersect(a, b):
        return False
    return not _covered(a, b) and not _covered(b, a)


def _boundary_geom(g):
    """The topological boundary as a geometry (None = empty set):
    area -> its rings as lines; open line -> its endpoints; point -> empty."""
    d = geometry_dimension(g)
    if d == 0:
        return None
    if d == 1:
        pts = _line_boundary_points(g)
        if not pts:
            return None
        return MultiPoint(tuple(Point(x, y) for x, y in pts))
    return MultiLineString(tuple(LineString(r) for r in g.rings()))


def _relate_cells(a, b):
    """The 9 DE-9IM cells as lazy thunks, row-major over
    (Interior, Boundary, Exterior) of a x b."""
    ba, bb = _boundary_geom(a), _boundary_geom(b)
    return (
        lambda: _interiors_intersect(a, b),
        lambda: bb is not None and _interiors_intersect(a, bb),
        lambda: not _covered(a, b),
        lambda: ba is not None and _interiors_intersect(ba, b),
        lambda: ba is not None
        and bb is not None
        and geometry_intersects(ba, bb),
        lambda: ba is not None and not _covered(ba, b),
        lambda: not _covered(b, a),
        lambda: bb is not None and not _covered(bb, a),
        lambda: True,
    )


def geometry_relate(a, b) -> str:
    """DE-9IM-lite matrix: 9 chars over (Interior, Boundary, Exterior) of
    a x b, row-major -- 'T' = the sets intersect, 'F' = they do not.
    Dimension digits are NOT computed (see relate_matches: pattern digits
    match any non-empty cell)."""
    return "".join("T" if cell() else "F" for cell in _relate_cells(a, b))


def validate_de9im_pattern(pattern: str) -> str:
    """Normalize + validate a DE-9IM pattern (the one shared rule: 9 chars
    of ``*TF012``). Returns the uppercased pattern; raises ValueError.
    Used by the matchers here and by the ECQL parser's parse-time check."""
    p = pattern.upper()
    if len(p) != 9 or any(c not in "*TF012" for c in p):
        raise ValueError(
            f"bad DE-9IM pattern {pattern!r} (9 chars of *TF012)"
        )
    return p


def relate_matches(matrix: str, pattern: str) -> bool:
    """Match a DE-9IM-lite matrix against a pattern. '*' matches anything;
    'T' and dimension digits '0'/'1'/'2' match any non-empty cell; 'F'
    matches empty. (Lite: we do not distinguish intersection dimensions.)"""
    if len(matrix) != 9:
        raise ValueError(f"DE-9IM matrix must be 9 chars: {matrix!r}")
    for m, p in zip(matrix.upper(), validate_de9im_pattern(pattern)):
        if p == "*":
            continue
        # a matrix cell is empty iff 'F' -- 'T' and dimension digits
        # ('0'/'1'/'2', as standard JTS matrices carry) are all non-empty
        if (m != "F") != (p != "F"):
            return False
    return True


def geometry_relate_matches(a, b, pattern: str) -> bool:
    """Pattern match without materializing the full matrix: only the cells
    the pattern constrains are computed (most masks constrain 2-3 of 9,
    and each cell costs segment-pair geometry work)."""
    pattern = validate_de9im_pattern(pattern)
    for p, cell in zip(pattern, _relate_cells(a, b)):
        if p == "*":
            continue
        if cell() != (p != "F"):
            return False
    return True
