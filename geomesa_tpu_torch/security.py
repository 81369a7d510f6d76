"""Per-feature visibility security.

Copy of ``geomesa_tpu/security.py``, trimmed to what the port uses:
``parse_visibility`` (the same grammar and the same
``VisibilityParseError`` messages), ``VisibilityEvaluator`` and
``filter_by_visibility``. The ``AuthorizationsProvider`` SPI is not
copied: nothing in the port resolves auths from a caller.

Features carry a visibility expression (Accumulo-style boolean label
grammar: ``&`` and, ``|`` or, parentheses, empty = public; tokens may be
quoted). A query with authorizations {A, C} sees a feature labeled
``A&(B|C)`` iff the expression evaluates true under that auth set. The
label rides the reserved ``__vis__`` batch column
(``features.batch.VIS_COLUMN``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from geomesa_tpu_torch.features.batch import VIS_COLUMN


class VisibilityParseError(ValueError):
    pass


# -- expression AST ----------------------------------------------------------


@dataclass(frozen=True)
class _Tok:
    value: str

    def evaluate(self, auths: frozenset) -> bool:
        return self.value in auths


@dataclass(frozen=True)
class _And:
    children: tuple

    def evaluate(self, auths: frozenset) -> bool:
        return all(c.evaluate(auths) for c in self.children)


@dataclass(frozen=True)
class _Or:
    children: tuple

    def evaluate(self, auths: frozenset) -> bool:
        return any(c.evaluate(auths) for c in self.children)


_TOKEN_CHARS = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.:/"
)


def parse_visibility(expr: str):
    """Parse an Accumulo-style visibility expression; None for public."""
    expr = expr.strip()
    if not expr:
        return None
    node, pos = _parse_expr(expr, 0)
    if pos != len(expr):
        raise VisibilityParseError(f"trailing input at {pos}: {expr!r}")
    return node


def _parse_expr(s: str, pos: int):
    """expr := term ((& term)* | (\\| term)*) -- like Accumulo, mixing
    & and | at one level without parens is an error."""
    node, pos = _parse_term(s, pos)
    op = None
    children = [node]
    while pos < len(s) and s[pos] in "&|":
        if op is None:
            op = s[pos]
        elif s[pos] != op:
            raise VisibilityParseError(
                f"mixed & and | need parentheses at {pos}: {s!r}"
            )
        nxt, pos2 = _parse_term(s, pos + 1)
        children.append(nxt)
        pos = pos2
    if op is None:
        return node, pos
    cls = _And if op == "&" else _Or
    return cls(tuple(children)), pos


def _parse_term(s: str, pos: int):
    if pos >= len(s):
        raise VisibilityParseError(f"unexpected end of expression: {s!r}")
    if s[pos] == "(":
        node, pos = _parse_expr(s, pos + 1)
        if pos >= len(s) or s[pos] != ")":
            raise VisibilityParseError(f"unbalanced parens in {s!r}")
        return node, pos + 1
    if s[pos] == '"':
        end = s.find('"', pos + 1)
        if end < 0:
            raise VisibilityParseError(f"unterminated quote in {s!r}")
        return _Tok(s[pos + 1 : end]), end + 1
    end = pos
    while end < len(s) and s[end] in _TOKEN_CHARS:
        end += 1
    if end == pos:
        raise VisibilityParseError(f"unexpected char {s[pos]!r} at {pos}")
    return _Tok(s[pos:end]), end


# -- evaluation --------------------------------------------------------------


class VisibilityEvaluator:
    """Evaluates labels against one auth set, memoizing per distinct label
    (typical datasets reuse a handful of labels across millions of rows)."""

    def __init__(self, auths):
        self.auths = frozenset(str(a) for a in auths)
        self._memo: dict = {}

    def can_see(self, label) -> bool:
        if label is None:
            return True
        label = str(label)
        if label not in self._memo:
            node = parse_visibility(label)
            self._memo[label] = node is None or node.evaluate(self.auths)
        return self._memo[label]

    def mask(self, labels: np.ndarray) -> np.ndarray:
        return np.fromiter(
            (self.can_see(v) for v in labels), dtype=bool, count=len(labels)
        )


def filter_by_visibility(batch, auths) -> "np.ndarray | None":
    """Bool mask of rows visible under auths, or None if the batch carries
    no visibility column (everything visible). ``auths=None`` means *no*
    authorizations -- labeled rows hide (fail closed), same as ``()``."""
    vis = batch.columns.get(VIS_COLUMN)
    if vis is None:
        return None
    return VisibilityEvaluator(auths or ()).mask(vis)
