"""Query predicate AST + parser (copy of `diskann_tpu/filters/predicate.py`,
which is pure Python; the copy also reports an unclosed parenthesis at the
end of the input as a ValueError).

Reference: `diskann-label-filter/src/parser/{ast,query_parser,evaluator}.rs`
(pest grammar per RFC 00105).  Grammar here:

    expr   := term (('|' | 'OR')  term)*
    term   := factor (('&' | 'AND') factor)*
    factor := '!' factor | '(' expr ')' | label
    label  := [A-Za-z0-9_.:-]+

The AST compiles to device boolean ops over gathered label-bitset rows, so
one predicate evaluation covers a whole ``[B, C]`` candidate batch.
"""

from __future__ import annotations

import dataclasses
import re


class Predicate:
    def evaluate(self, labelset, ids, valid):
        """-> bool mask with the shape of `ids`."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Label(Predicate):
    name: str

    def evaluate(self, labelset, ids, valid):
        return labelset.test(self.name, ids) & valid


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    left: Predicate
    right: Predicate

    def evaluate(self, labelset, ids, valid):
        return self.left.evaluate(labelset, ids, valid) & self.right.evaluate(
            labelset, ids, valid
        )


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    left: Predicate
    right: Predicate

    def evaluate(self, labelset, ids, valid):
        return self.left.evaluate(labelset, ids, valid) | self.right.evaluate(
            labelset, ids, valid
        )


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    inner: Predicate

    def evaluate(self, labelset, ids, valid):
        return (~self.inner.evaluate(labelset, ids, valid)) & valid


_TOKEN = re.compile(r"\s*(\(|\)|\||&|!|~|AND\b|OR\b|NOT\b|[A-Za-z0-9_.:\-]+)")


def _tokenize(s: str) -> list[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip():
                raise ValueError(f"bad predicate at {s[pos:]!r}")
            break
        out.append(m.group(1))
        pos = m.end()
    return out


def parse_predicate(s: str) -> Predicate:
    toks = _tokenize(s)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def take():
        nonlocal pos
        if pos >= len(toks):
            # e.g. "(a": the reference's copy raises IndexError here
            raise ValueError(f"unexpected end of predicate {s!r}")
        t = toks[pos]
        pos += 1
        return t

    def factor() -> Predicate:
        t = peek()
        if t in ("!", "~", "NOT"):
            take()
            return Not(factor())
        if t == "(":
            take()
            e = expr()
            if take() != ")":
                raise ValueError("unbalanced parens")
            return e
        if t is None or t in (")", "&", "|", "AND", "OR"):
            raise ValueError(f"unexpected token {t!r}")
        return Label(take())

    def term() -> Predicate:
        e = factor()
        while peek() in ("&", "AND"):
            take()
            e = And(e, factor())
        return e

    def expr() -> Predicate:
        e = term()
        while peek() in ("|", "OR"):
            take()
            e = Or(e, term())
        return e

    e = expr()
    if pos != len(toks):
        raise ValueError(f"trailing tokens: {toks[pos:]}")
    return e
