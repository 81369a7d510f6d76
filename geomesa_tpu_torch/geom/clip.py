"""Polygon boolean operations (intersection / union / difference).

Copy of ``geomesa_tpu/geom/clip.py`` (``clip_rings`` ``:290``,
``polygon_intersection`` ``:421``, ``polygon_union`` ``:465``,
``polygon_difference`` ``:518``, ``polygon_sym_difference`` ``:555``), its
degenerate-case perturbation (``_perturb``) and ``_Degenerate`` handling
included, so the results equal the counterpart's ring for ring. The
reference gets
``st_intersection`` / ``st_difference`` and friends from JTS's overlay
engine (geomesa-spark-jts). This is a Greiner-Hormann clipper:
concave shapes are fine; MultiPolygons distribute over their disjoint
components. All four ops (intersection, union, difference,
symDifference) support holes on either side; difference and union may
CREATE holes/voids in their output (a union that encloses a void routes
through the exact A + (B \\ A) decomposition). The remaining loud
refusals are genuinely pathological: hole-region merges that enclose a
void during subtraction, and multipolygons with a component inside
another component's hole.

Degeneracies (a vertex exactly on the other polygon's edge, collinear
overlapping edges) are handled the standard practical way: the clip
polygon is retried with a deterministic perturbation that starts at
1e-8 of the bbox scale and escalates to 1e-7 on the second retry,
CAPPED there (further retries re-roll at the cap with a new seed).
For geographic data 1e-7 of a bbox span is at most ~cm-scale —
still below meaningful coordinate precision; the test suite validates
results against a Monte-Carlo point-membership oracle built on
points_in_polygon.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.geom.base import MultiPolygon, Polygon


class _Node:
    __slots__ = (
        "xy", "next", "prev", "neighbor", "is_inter", "entry", "visited",
        "alpha",
    )

    def __init__(self, xy, alpha=0.0, is_inter=False):
        self.xy = xy
        self.next = None
        self.prev = None
        self.neighbor = None
        self.is_inter = is_inter
        self.entry = False
        self.visited = False
        self.alpha = alpha


def _norm_ring(ring) -> np.ndarray:
    """Closed-or-open ring -> OPEN CCW-normalized float64 ring."""
    c = np.asarray(ring, np.float64)
    if np.array_equal(c[0], c[-1]):
        c = c[:-1]
    area2 = np.sum(c[:, 0] * np.roll(c[:, 1], -1) - np.roll(c[:, 0], -1) * c[:, 1])
    if area2 < 0:
        c = c[::-1]
    return c


def _ring_of(poly: Polygon) -> np.ndarray:
    rings = list(poly.rings())
    if len(rings) > 1:
        raise NotImplementedError(
            "this polygon boolean op does not support holes (v1); "
            "intersection does — or subtract the holes explicitly"
        )
    return _norm_ring(rings[0])


def _components(g) -> list:
    """(Multi)Polygon -> [(open shell ring, [open hole rings...]), ...]."""
    out = []
    for p in _as_polys(g):
        rings = list(p.rings())
        out.append((
            _norm_ring(rings[0]), [_norm_ring(h) for h in rings[1:]]
        ))
    return out


def _build_list(ring: np.ndarray) -> _Node:
    nodes = [_Node(tuple(p)) for p in ring]
    for i, nd in enumerate(nodes):
        nd.next = nodes[(i + 1) % len(nodes)]
        nd.prev = nodes[i - 1]
    return nodes[0]


def _vertices(head: _Node):
    n = head
    while True:
        yield n
        n = n.next
        if n is head:
            break


def _orig_edges(head: _Node):
    """(node, next_original_node) pairs over the ORIGINAL polygon edges."""
    orig = [n for n in _vertices(head) if not n.is_inter]
    for i, a in enumerate(orig):
        yield a, orig[(i + 1) % len(orig)]


def _seg_inter(p1, p2, q1, q2):
    """(t, u) of the proper crossing of segments p1p2 and q1q2, or None.
    Returns None for parallel/degenerate configurations (endpoint
    touches are 'degenerate' and trigger the perturbation retry)."""
    r = (p2[0] - p1[0], p2[1] - p1[1])
    s = (q2[0] - q1[0], q2[1] - q1[1])
    rxs = r[0] * s[1] - r[1] * s[0]
    if rxs == 0:
        qp = (q1[0] - p1[0], q1[1] - p1[1])
        if qp[0] * r[1] - qp[1] * r[0] == 0:
            # collinear: overlap is degenerate, separation is a miss
            return "degenerate" if _collinear_overlap(p1, p2, q1, q2) else None
        return None
    qp = (q1[0] - p1[0], q1[1] - p1[1])
    t = (qp[0] * s[1] - qp[1] * s[0]) / rxs
    u = (qp[0] * r[1] - qp[1] * r[0]) / rxs
    eps = 1e-13
    if -eps < t < eps or 1 - eps < t < 1 + eps or \
       -eps < u < eps or 1 - eps < u < 1 + eps:
        if -eps < t < 1 + eps and -eps < u < 1 + eps:
            return "degenerate"  # endpoint on the other segment
        return None
    if 0 < t < 1 and 0 < u < 1:
        return (t, u)
    return None


def _collinear_overlap(p1, p2, q1, q2) -> bool:
    if p1[0] == p2[0]:  # vertical: compare on y
        a = sorted((p1[1], p2[1]))
        b = sorted((q1[1], q2[1]))
    else:
        a = sorted((p1[0], p2[0]))
        b = sorted((q1[0], q2[0]))
    return a[0] < b[1] and b[0] < a[1]


def _point_in_ring(pt, ring: np.ndarray) -> bool:
    from geomesa_tpu_torch.geom.predicates import points_in_polygon

    closed = np.concatenate([ring, ring[:1]], axis=0)
    return bool(
        points_in_polygon(
            np.array([pt[0]]), np.array([pt[1]]), [closed]
        )[0]
    )


def _insert_intersections(head_a: _Node, head_b: _Node) -> int:
    """Find all proper crossings, link neighbor nodes. Returns the count;
    raises _Degenerate on non-generic configurations."""
    count = 0
    for a1, a2 in list(_orig_edges(head_a)):
        for b1, b2 in list(_orig_edges(head_b)):
            got = _seg_inter(a1.xy, a2.xy, b1.xy, b2.xy)
            if got is None:
                continue
            if got == "degenerate":
                raise _Degenerate()
            t, u = got
            xy = (
                a1.xy[0] + t * (a2.xy[0] - a1.xy[0]),
                a1.xy[1] + t * (a2.xy[1] - a1.xy[1]),
            )
            na = _Node(xy, alpha=t, is_inter=True)
            nb = _Node(xy, alpha=u, is_inter=True)
            na.neighbor = nb
            nb.neighbor = na
            _insert_sorted(a1, a2, na)
            _insert_sorted(b1, b2, nb)
            count += 1
    return count


class _Degenerate(Exception):
    pass


def _insert_sorted(start: _Node, end_orig: _Node, node: _Node) -> None:
    """Insert an intersection node between two ORIGINAL vertices, keeping
    intersection nodes ordered by alpha."""
    cur = start
    while (
        cur.next is not end_orig
        and cur.next.is_inter
        and cur.next.alpha < node.alpha
    ):
        cur = cur.next
    node.next = cur.next
    node.prev = cur
    cur.next.prev = node
    cur.next = node


def _mark_entries(head: _Node, other_ring: np.ndarray, invert: bool) -> None:
    """Classic GH phase 2: walking the polygon, each crossing toggles
    containment in the other polygon; a node is an ENTRY if we were
    outside before crossing (XOR ``invert`` for union/difference)."""
    inside = _point_in_ring(head.xy, other_ring)
    entry = not inside
    for n in _vertices(head):
        if n.is_inter:
            n.entry = entry ^ invert
            entry = not entry


def _traverse(head_a: _Node) -> list:
    """GH phase 3: walk unvisited intersection nodes into result rings."""
    rings = []
    inters = [n for n in _vertices(head_a) if n.is_inter]
    for start in inters:
        if start.visited:
            continue
        ring = []
        cur = start
        while not cur.visited:
            cur.visited = True
            cur.neighbor.visited = True
            ring.append(cur.xy)
            if cur.entry:
                nxt = cur.next
                while not nxt.is_inter:
                    ring.append(nxt.xy)
                    nxt = nxt.next
            else:
                nxt = cur.prev
                while not nxt.is_inter:
                    ring.append(nxt.xy)
                    nxt = nxt.prev
            cur = nxt.neighbor
        if len(ring) >= 3:
            rings.append(np.array(ring + [ring[0]], np.float64))
    return rings


def _clip_once(ra: np.ndarray, rb: np.ndarray, op: str):
    head_a = _build_list(ra)
    head_b = _build_list(rb)
    n_inter = _insert_intersections(head_a, head_b)
    if n_inter == 0:
        a_in_b = _point_in_ring(ra[0], rb)
        b_in_a = _point_in_ring(rb[0], ra)
        if op == "intersection":
            if a_in_b:
                return [np.concatenate([ra, ra[:1]])]
            if b_in_a:
                return [np.concatenate([rb, rb[:1]])]
            return []
        if op == "union":
            if a_in_b:
                return [np.concatenate([rb, rb[:1]])]
            if b_in_a:
                return [np.concatenate([ra, ra[:1]])]
            return [np.concatenate([ra, ra[:1]]),
                    np.concatenate([rb, rb[:1]])]
        # difference a - b
        if a_in_b:
            return []
        if b_in_a:
            raise NotImplementedError(
                "difference would create a hole (clip polygon strictly "
                "inside the subject); holes are unsupported in v1"
            )
        return [np.concatenate([ra, ra[:1]])]
    # entry-mark inversion table (Kim & Kim formulation): intersection
    # marks both normally; union inverts both; difference inverts the
    # SUBJECT's marks (flipping the walk direction along A is equivalent
    # to clipping A against B's reversed ring — validated against the
    # Monte-Carlo membership oracle in tests/test_clip.py)
    inv_a, inv_b = {
        "intersection": (False, False),
        "union": (True, True),
        "difference": (True, False),
    }[op]
    _mark_entries(head_a, rb, inv_a)
    _mark_entries(head_b, ra, inv_b)
    return _traverse(head_a)


def _perturb(ring: np.ndarray, k: int, scale: float) -> np.ndarray:
    rng = np.random.default_rng(0xC11F + k)
    return ring + (rng.random(ring.shape) - 0.5) * scale


def clip_rings(ra: np.ndarray, rb: np.ndarray, op: str) -> list:
    """Boolean op over two simple open rings -> list of closed rings.
    Retries with a deterministic perturbation of the clip ring on
    degenerate (vertex-on-edge / collinear-overlap) inputs, escalating
    1e-8 -> 1e-7 of the bbox span (capped; later retries re-roll at the
    cap with a fresh seed). The scale is floored at a few ULP of the
    coordinate MAGNITUDE — a small polygon far from the origin (e.g.
    EPSG:3857 metres) would otherwise round the perturbation away
    entirely and retry the identical degenerate input."""
    span = max(
        float(np.ptp(ra[:, 0])), float(np.ptp(ra[:, 1])),
        float(np.ptp(rb[:, 0])), float(np.ptp(rb[:, 1])), 1e-9,
    )
    mag = max(
        float(np.abs(ra).max()), float(np.abs(rb).max()), 1.0
    )
    base = max(span * 1e-9, float(np.spacing(mag)) * 4)
    for k in range(6):
        try:
            return _clip_once(ra, rb if k == 0 else _perturb(
                rb, k, base * (10 ** min(k, 2))
            ), op)
        except _Degenerate:
            continue
    raise ValueError(
        "polygon boolean op did not reach a generic configuration after "
        "perturbation retries"
    )


def _as_polys(g):
    if isinstance(g, Polygon):
        return [g]
    if isinstance(g, MultiPolygon):
        return list(g.polygons)
    raise ValueError(
        f"polygon boolean ops need (Multi)Polygon, got {type(g).__name__}"
    )


def _wrap_parts(parts: list):
    """[(closed ring, [closed holes...])] -> (Multi)Polygon; one policy
    for the empty/single/multi wrapping across every op."""
    polys = [
        Polygon(r, tuple(hs)) if hs else Polygon(r)
        for r, hs in parts
        if abs(_ring_area2(r)) > 0
    ]
    if not polys:
        return MultiPolygon(())
    if len(polys) == 1:
        return polys[0]
    return MultiPolygon(tuple(polys))


def _wrap(rings: list):
    return _wrap_parts([(r, []) for r in rings])


def _ring_area2(r: np.ndarray) -> float:
    return float(
        np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1])
    )


def _merge_regions(regions: list) -> list:
    """Fold possibly-overlapping simple regions (open rings) into disjoint
    ones via pairwise union. A union whose pieces nest (two horseshoes
    closing a void) is refused — that topology needs full hole-aware
    union."""
    merged: list = []  # open rings, pairwise disjoint
    for h in regions:
        cur = h
        out = []
        for ex in merged:
            got = clip_rings(ex, cur, "union")
            if len(got) == 1:
                cur = _norm_ring(got[0])  # overlapped: fold and continue
                continue
            # 2+ rings: either genuinely disjoint inputs, or an
            # interlocking union that ENCLOSED A VOID (two horseshoes) —
            # the void ring nests inside the outer ring. The nested case
            # must refuse: emitting both rings as "holes" would
            # double-count the void under even-odd membership.
            for g1 in got:
                for g2 in got:
                    if g1 is not g2 and _point_in_ring(
                        _norm_ring(g1)[0], _norm_ring(g2)
                    ):
                        raise NotImplementedError(
                            "merged hole regions enclose a void "
                            "(interlocking union); this topology is "
                            "not supported"
                        )
            out.append(ex)  # disjoint: keep apart
        out.append(cur)
        merged = out
    return merged


def _subtract_regions(rings: list, regions: list) -> list:
    """Closed simple rings minus disjoint simple regions (open rings) ->
    [(closed shell, [closed holes...])]. Regions crossing a ring's
    boundary trim/split it; regions strictly inside attach as holes;
    disjoint regions are no-ops — all three cases fall out of the
    simple-ring difference (whose 'would create a hole' refusal IS the
    attach signal)."""
    pieces = list(rings)
    pending: list = []
    for h in regions:
        nxt = []
        for r in pieces:
            try:
                # re-normalize: traversal outputs carry arbitrary
                # orientation, the clip contract wants CCW open rings
                nxt.extend(clip_rings(_norm_ring(r), h, "difference"))
            except NotImplementedError:
                nxt.append(r)  # strictly inside: attach after splitting
                pending.append(h)
        pieces = nxt
    out = []
    for r in pieces:
        holes = [
            np.concatenate([h, h[:1]])
            for h in pending
            if _point_in_ring(h[0], r[:-1])
        ]
        out.append((r, holes))
    return out


def polygon_intersection(a, b):
    """A ∩ B over (Multi)Polygons, WITH hole support: per component pair
    the shells intersect via Greiner-Hormann, then both sides' hole
    regions (merged where they overlap) subtract from the result —
    crossing holes trim the rings, contained holes carry through as
    holes of the output. Multipolygon components distribute (parts are
    disjoint by construction)."""
    parts = []
    comps_b = _components(b)
    merged_cache: dict = {}
    for i, (sa, ha) in enumerate(_components(a)):
        for j, (sb, hb) in enumerate(comps_b):
            got = clip_rings(sa, sb, "intersection")
            if not got:
                continue
            if ha or hb:
                if (i, j) not in merged_cache:
                    merged_cache[(i, j)] = _merge_regions(ha + hb)
                holes = merged_cache[(i, j)]
            else:
                holes = []
            parts += _subtract_regions(got, holes)
    return _wrap_parts(parts)


def _union_via_difference(a, b):
    """A ∪ B as A + (B \\ A): pieces have pairwise disjoint INTERIORS by
    construction (they may touch along A's boundary), so membership and
    area are exact for any topology the hole-aware difference accepts —
    including unions that enclose a void and holed inputs. The trade-off
    is aesthetic: an overlapping pair yields two touching components
    instead of one merged ring."""
    parts = []
    for g in (a, polygon_difference(b, a)):
        if _is_empty(g):
            continue
        for shell, holes in _components(g):
            parts.append((
                np.concatenate([shell, shell[:1]]),
                [np.concatenate([h, h[:1]]) for h in holes],
            ))
    return _wrap_parts(parts)


def polygon_union(a, b):
    """A ∪ B. Simple inputs fold pairwise through the Greiner-Hormann
    union (one merged ring where shapes overlap); holed inputs — and
    simple pairs whose union ENCLOSES A VOID (interlocking horseshoes,
    where the fold would silently emit overlapping rings) — route
    through the exact disjoint decomposition A + (B \\ A)."""
    comps_a = _components(a)
    comps_b = _components(b)
    if any(h for _, h in comps_a) or any(h for _, h in comps_b):
        return _union_via_difference(a, b)
    parts = [s for s, _ in comps_a]
    for rb, _ in comps_b:
        merged = False
        out = []
        for ra in parts:
            if not merged:
                got = clip_rings(ra, rb, "union")
                if len(got) == 1:
                    rb = _norm_ring(got[0])  # merged: keep folding
                    merged = True
                    continue
                # 2+ rings: disjoint inputs, OR an interlocking union
                # that enclosed a void (one output ring nests inside
                # another) — the fold cannot represent that; use the
                # exact decomposition for the whole operation
                for g1 in got:
                    for g2 in got:
                        if g1 is not g2 and _point_in_ring(
                            _norm_ring(g1)[0], _norm_ring(g2)
                        ):
                            return _union_via_difference(a, b)
            out.append(ra)
        out.append(rb)
        parts = out
    return _wrap([np.concatenate([r, r[:1]]) for r in parts])


def _check_no_island_in_hole(comps: list) -> None:
    """Refuse multipolygons where one component sits inside another
    component's hole (donut-with-island): the difference decomposition's
    hole add-back would resurrect the island's area."""
    for j, (_, hj) in enumerate(comps):
        for k, (sk, _) in enumerate(comps):
            if j == k:
                continue
            for h in hj:
                if _point_in_ring(sk[0], h):
                    raise NotImplementedError(
                        "a multipolygon component lies inside another "
                        "component's hole; this topology is not supported"
                    )


def polygon_difference(a, b):
    """A \\ B, WITH hole support on both sides.

    Decomposition (all pieces pairwise disjoint, so no degenerate
    adjacencies): since B = ∪_j (shell_j − holes_j),

        A \\ B  =  (shell_A − merge(holes_A ∪ shells_B))  ∪
                   (A ∩ holes_B)

    — the first term over-subtracts B's full shells, the second adds
    back what survives inside B's holes (a holed INTERSECTION, already
    supported). Component-inside-another's-hole multipolygons refuse.
    """
    comps_a = _components(a)
    comps_b = _components(b)
    _check_no_island_in_hole(comps_a)
    _check_no_island_in_hole(comps_b)
    parts = []
    shells_b = [sb for sb, _ in comps_b]
    for sa, ha in comps_a:
        merged = _merge_regions(list(ha) + shells_b)
        parts += _subtract_regions(
            [np.concatenate([sa, sa[:1]])], merged
        )
    for sb, hb in comps_b:
        for h in hb:
            got = polygon_intersection(
                a, Polygon(np.concatenate([h, h[:1]]))
            )
            parts += [
                (np.asarray(list(p.rings())[0], np.float64),
                 [np.asarray(r, np.float64) for r in list(p.rings())[1:]])
                for p in _as_polys(got)
            ]
    return _wrap_parts(parts)


def polygon_sym_difference(a, b):
    """(A \\ B) ∪ (B \\ A) — returned as the (possibly Multi) collection
    of both directional differences (they are disjoint by construction;
    holes on either input ride through the hole-aware difference)."""
    parts = []
    for g in (polygon_difference(a, b), polygon_difference(b, a)):
        if _is_empty(g):
            continue
        for shell, holes in _components(g):
            parts.append((
                np.concatenate([shell, shell[:1]]),
                [np.concatenate([h, h[:1]]) for h in holes],
            ))
    return _wrap_parts(parts)


def _is_empty(g) -> bool:
    return isinstance(g, MultiPolygon) and len(g.polygons) == 0
