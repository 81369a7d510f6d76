"""(E)CQL text parser for the supported filter subset.

Copy of ``geomesa_tpu/filter/ecql.py`` (the whole parser).

Grammar (recursive descent, case-insensitive keywords):

    filter    := or
    or        := and (OR and)*
    and       := not (AND not)*
    not       := NOT not | primary
    primary   := '(' filter ')' | INCLUDE | EXCLUDE | spatial | predicate
    spatial   := BBOX '(' attr ',' num ',' num ',' num ',' num [',' str] ')'
               | INTERSECTS/WITHIN/CONTAINS/DISJOINT '(' attr ',' wkt ')'
               | DWITHIN '(' attr ',' wkt ',' num ',' units ')'
    predicate := attr op literal                 op in = <> != < <= > >=
               | attr BETWEEN literal AND literal
               | attr DURING instant '/' instant
               | attr (AFTER|BEFORE) instant
               | attr IN '(' literal (',' literal)* ')'
               | attr LIKE string
               | attr IS [NOT] NULL
    literal   := number | 'string' | instant
    instant   := ISO-8601 date-time (optionally quoted)

Matches the operator coverage GeoMesa's planner extracts bounds from.
"""

from __future__ import annotations

import re

import numpy as np

from geomesa_tpu_torch.filter import ast
from geomesa_tpu_torch.geom import Envelope, Polygon, parse_wkt
from geomesa_tpu_torch.geom.predicates import validate_de9im_pattern

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<lparen>\()
      | (?P<rparen>\))
      | (?P<comma>,)
      | (?P<slash>/)
      | (?P<op><=|>=|<>|!=|=|<|>)
      | (?P<string>'(?:[^']|'')*')
      | (?P<datetime>\d{4}-\d{2}-\d{2}T[\d:.]+Z?)
      | (?P<number>-?\d+\.?\d*(?:[eE][-+]?\d+)?)
      | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)

_SPATIAL = {
    "BBOX",
    "INTERSECTS",
    "WITHIN",
    "CONTAINS",
    "DISJOINT",
    "DWITHIN",
    "CROSSES",
    "TOUCHES",
    "OVERLAPS",
    "EQUALS",
    "RELATE",
}


class _P:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise ValueError(f"cannot tokenize at {text[pos:pos+20]!r}")
                break
            pos = m.end()
            for name, val in m.groupdict().items():
                if val is not None:
                    self.toks.append((name, val))
                    break
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        if t[0] is None:
            raise ValueError("unexpected end of filter")
        self.i += 1
        return t

    def expect(self, kind: str, val: str | None = None):
        k, v = self.next()
        if k != kind or (val is not None and v.upper() != val):
            raise ValueError(f"expected {val or kind}, got {v!r}")
        return v

    def at_word(self, *words: str) -> bool:
        k, v = self.peek()
        return k == "word" and v.upper() in words


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


def parse_instant(s: str) -> int:
    """ISO-8601 -> epoch millis (UTC)."""
    s = s.strip()
    if s.endswith("Z"):
        s = s[:-1]
    return int(np.datetime64(s, "ms").astype(np.int64))


_DT_RE = re.compile(r"^\d{4}-\d{2}-\d{2}(T[\d:.]+Z?)?$")


def _instant_tok(tok) -> int:
    """Instant from a datetime or (quoted) string token."""
    kind, val = tok
    if kind == "string":
        return parse_instant(_unquote(val))
    return parse_instant(val)


def _literal(tok) -> object:
    kind, val = tok
    if kind == "number":
        f = float(val)
        return int(f) if f.is_integer() and "." not in val and "e" not in val.lower() else f
    if kind == "string":
        s = _unquote(val)
        if _DT_RE.match(s):
            try:
                return parse_instant(s)
            except Exception:
                return s
        return s
    if kind == "datetime":
        return parse_instant(val)
    raise ValueError(f"expected literal, got {val!r}")


def parse_ecql(text: str) -> ast.Filter:
    text = text.strip()
    if not text:
        return ast.Include
    p = _P(text)
    f = _or(p)
    if p.peek()[0] is not None:
        raise ValueError(f"trailing input at {p.peek()[1]!r}")
    return f


def _or(p: _P) -> ast.Filter:
    left = _and(p)
    parts = [left]
    while p.at_word("OR"):
        p.next()
        parts.append(_and(p))
    return parts[0] if len(parts) == 1 else ast.Or(tuple(parts))


def _and(p: _P) -> ast.Filter:
    parts = [_not(p)]
    while p.at_word("AND"):
        p.next()
        parts.append(_not(p))
    return parts[0] if len(parts) == 1 else ast.And(tuple(parts))


def _not(p: _P) -> ast.Filter:
    if p.at_word("NOT"):
        p.next()
        return ast.Not(_not(p))
    return _primary(p)


def _wkt_geom(p: _P):
    """Consume a WKT geometry (word + balanced parens) from the stream."""
    kind, word = p.next()
    if kind != "word":
        raise ValueError(f"expected geometry, got {word!r}")
    start = p.i
    p.expect("lparen")
    depth = 1
    while depth:
        k, v = p.next()
        if k == "lparen":
            depth += 1
        elif k == "rparen":
            depth -= 1
    # reconstruct the wkt text span
    toks = p.toks[start : p.i]
    body = ""
    for k, v in toks:
        body += v if k != "comma" else ", "
        if k in ("number",):
            body += " "
    return parse_wkt(word + " " + body)


def _primary(p: _P) -> ast.Filter:
    kind, val = p.peek()
    if kind == "lparen":
        p.next()
        f = _or(p)
        p.expect("rparen")
        return f
    if kind != "word":
        raise ValueError(f"unexpected token {val!r}")
    upper = val.upper()
    if upper == "INCLUDE":
        p.next()
        return ast.Include
    if upper == "EXCLUDE":
        p.next()
        return ast.Exclude
    # spatial verbs are only reserved when called like functions -- a
    # column may legitimately be named 'overlaps' or 'equals'
    if upper in _SPATIAL and p.peek(1)[0] == "lparen":
        return _spatial(p, upper)
    return _predicate(p)


def _spatial(p: _P, op: str) -> ast.Filter:
    p.next()  # the op word
    p.expect("lparen")
    attr = p.expect("word")
    p.expect("comma")
    if op == "BBOX":
        nums = []
        for i in range(4):
            k, v = p.next()
            if k != "number":
                raise ValueError(f"BBOX expects numbers, got {v!r}")
            nums.append(float(v))
            if i < 3:
                p.expect("comma")
        # optional crs string
        if p.peek()[0] == "comma":
            p.next()
            p.next()  # crs literal, ignored (4326 assumed)
        p.expect("rparen")
        return ast.BBox(attr, nums[0], nums[1], nums[2], nums[3])
    geom = _wkt_geom(p)
    if isinstance(geom, Envelope):
        geom_poly = Polygon(
            [
                (geom.xmin, geom.ymin),
                (geom.xmax, geom.ymin),
                (geom.xmax, geom.ymax),
                (geom.xmin, geom.ymax),
                (geom.xmin, geom.ymin),
            ]
        )
    else:
        geom_poly = geom
    if op == "DWITHIN":
        p.expect("comma")
        k, v = p.next()
        dist = float(v)
        p.expect("comma")
        units = p.expect("word").lower()
        p.expect("rparen")
        factor = {
            "meters": 1 / 111_320.0,
            "kilometers": 1 / 111.32,
            "feet": 0.3048 / 111_320.0,
            "statute": 1609.34 / 111_320.0,
        }.get(units, 1.0)
        return ast.DWithin(attr, geom_poly, dist * factor)
    if op == "RELATE":
        p.expect("comma")
        k, v = p.next()
        if k != "string":
            raise ValueError(f"RELATE expects a DE-9IM pattern string, got {v!r}")
        # fail at parse time, not deep inside a per-row scan
        pat = validate_de9im_pattern(_unquote(v))
        p.expect("rparen")
        return ast.Intersects(attr, geom_poly, op="relate", pattern=pat)
    p.expect("rparen")
    return ast.Intersects(attr, geom_poly, op=op.lower())


def _predicate(p: _P) -> ast.Filter:
    attr = p.expect("word")
    kind, val = p.peek()
    if kind == "op":
        p.next()
        lit = _literal(p.next())
        op = "<>" if val == "!=" else val
        return ast.Compare(op, attr, lit)
    if kind != "word":
        raise ValueError(f"unexpected {val!r} after {attr!r}")
    word = val.upper()
    p.next()
    if word == "BETWEEN":
        lo = _literal(p.next())
        p.expect("word", "AND")
        hi = _literal(p.next())
        return ast.Between(attr, lo, hi)
    if word == "DURING":
        t0 = _instant_tok(p.next())
        p.expect("slash")
        t1 = _instant_tok(p.next())
        return ast.During(attr, t0, t1)
    if word == "AFTER":
        return ast.Compare(">", attr, _instant_tok(p.next()))
    if word == "BEFORE":
        return ast.Compare("<", attr, _instant_tok(p.next()))
    if word == "IN":
        p.expect("lparen")
        vals = [_literal(p.next())]
        while p.peek()[0] == "comma":
            p.next()
            vals.append(_literal(p.next()))
        p.expect("rparen")
        return ast.In(attr, tuple(vals))
    if word == "LIKE":
        k, v = p.next()
        if k != "string":
            raise ValueError("LIKE expects a string pattern")
        return ast.Like(attr, _unquote(v))
    if word == "IS":
        negate = False
        if p.at_word("NOT"):
            p.next()
            negate = True
        p.expect("word", "NULL")
        return ast.IsNull(attr, negate)
    raise ValueError(f"unsupported predicate {word!r}")
