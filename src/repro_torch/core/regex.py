"""Regular-expression AST + parser for RPQ path constraints.

Grammar (paper Definition 7, plus the sugar the paper uses):

    R := eps | a | R . R | R + R | R* | R? | R^+

Concrete syntax accepted by :func:`parse`:

    alternation:    ``a + b``  (also ``a | b``)
    concatenation:  ``a . b``  (also ``a b`` by juxtaposition, ``a o b``)
    kleene star:    ``a*``
    plus:           ``a+`` suffix -- disambiguated from alternation by position
    optional:       ``a?``
    grouping:       ``( ... )``
    epsilon:        ``()`` or ``eps``

Labels are identifiers ``[A-Za-z_][A-Za-z0-9_]*`` or single characters.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple, Union


class Node:
    """Base class for regex AST nodes."""

    def labels(self) -> frozenset:
        raise NotImplementedError

    def size(self) -> int:
        """Query size per the paper: #labels + #occurrences of * and +."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Eps(Node):
    def labels(self) -> frozenset:
        return frozenset()

    def size(self) -> int:
        return 0

    def __str__(self) -> str:
        return "eps"


@dataclasses.dataclass(frozen=True)
class Sym(Node):
    label: str

    def labels(self) -> frozenset:
        return frozenset({self.label})

    def size(self) -> int:
        return 1

    def __str__(self) -> str:
        return self.label


@dataclasses.dataclass(frozen=True)
class Cat(Node):
    left: Node
    right: Node

    def labels(self) -> frozenset:
        return self.left.labels() | self.right.labels()

    def size(self) -> int:
        return self.left.size() + self.right.size()

    def __str__(self) -> str:
        return f"({self.left} . {self.right})"


@dataclasses.dataclass(frozen=True)
class Alt(Node):
    left: Node
    right: Node

    def labels(self) -> frozenset:
        return self.left.labels() | self.right.labels()

    def size(self) -> int:
        return self.left.size() + self.right.size()

    def __str__(self) -> str:
        return f"({self.left} + {self.right})"


@dataclasses.dataclass(frozen=True)
class Star(Node):
    inner: Node

    def labels(self) -> frozenset:
        return self.inner.labels()

    def size(self) -> int:
        return self.inner.size() + 1

    def __str__(self) -> str:
        return f"{self.inner}*"


@dataclasses.dataclass(frozen=True)
class Plus(Node):
    inner: Node

    def labels(self) -> frozenset:
        return self.inner.labels()

    def size(self) -> int:
        return self.inner.size() + 1

    def __str__(self) -> str:
        return f"{self.inner}^+"


@dataclasses.dataclass(frozen=True)
class Opt(Node):
    inner: Node

    def labels(self) -> frozenset:
        return self.inner.labels()

    def size(self) -> int:
        return self.inner.size()

    def __str__(self) -> str:
        return f"{self.inner}?"


Token = Tuple[str, str]  # (kind, text)


def _tokenize(src: str) -> Iterator[Token]:
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c == "(":
            yield ("LPAR", c)
            i += 1
        elif c == ")":
            yield ("RPAR", c)
            i += 1
        elif c == "*":
            yield ("STAR", c)
            i += 1
        elif c == "?":
            yield ("OPT", c)
            i += 1
        elif c in "+|":
            yield ("PLUSBAR", c)
            i += 1
        elif c in ".":
            yield ("DOT", c)
            i += 1
        elif c == "∘":  # ∘ concatenation
            yield ("DOT", c)
            i += 1
        elif c.isalnum() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word == "o" and i > 0:  # infix 'o' as concatenation marker
                yield ("DOT", word)
            elif word == "eps":
                yield ("EPS", word)
            else:
                yield ("SYM", word)
            i = j
        else:
            raise ValueError(f"unexpected character {c!r} in regex {src!r}")


class _Parser:
    """Recursive-descent parser.

    ``+``/``|`` between terms is alternation; ``+`` *immediately following* a
    term with no following term (i.e. used as a postfix where the next token
    cannot start a term) is one-or-more. We disambiguate with one token of
    lookahead: a PLUSBAR is postfix-plus iff the next token is not the start
    of a term (SYM/LPAR/EPS).
    """

    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.pos = 0

    def peek(self, off: int = 0) -> Union[Token, None]:
        if self.pos + off < len(self.toks):
            return self.toks[self.pos + off]
        return None

    def eat(self, kind: str) -> Token:
        tok = self.peek()
        if tok is None or tok[0] != kind:
            raise ValueError(f"expected {kind}, got {tok} at {self.pos}")
        self.pos += 1
        return tok

    def parse(self) -> Node:
        node = self.alternation()
        if self.pos != len(self.toks):
            raise ValueError(f"trailing tokens at {self.pos}: {self.toks[self.pos:]}")
        return node

    def alternation(self) -> Node:
        node = self.concatenation()
        while True:
            tok = self.peek()
            if tok is not None and tok[0] == "PLUSBAR" and self._starts_term(self.peek(1)):
                self.eat("PLUSBAR")
                node = Alt(node, self.concatenation())
            else:
                return node

    @staticmethod
    def _starts_term(tok: Union[Token, None]) -> bool:
        return tok is not None and tok[0] in ("SYM", "LPAR", "EPS")

    def concatenation(self) -> Node:
        node = self.postfix()
        while True:
            tok = self.peek()
            if tok is not None and tok[0] == "DOT":
                self.eat("DOT")
                node = Cat(node, self.postfix())
            elif self._starts_term(tok):
                node = Cat(node, self.postfix())
            else:
                return node

    def postfix(self) -> Node:
        node = self.atom()
        while True:
            tok = self.peek()
            if tok is None:
                return node
            if tok[0] == "STAR":
                self.eat("STAR")
                node = Star(node)
            elif tok[0] == "OPT":
                self.eat("OPT")
                node = Opt(node)
            elif tok[0] == "PLUSBAR" and not self._starts_term(self.peek(1)):
                self.eat("PLUSBAR")
                node = Plus(node)
            else:
                return node

    def atom(self) -> Node:
        tok = self.peek()
        if tok is None:
            raise ValueError("unexpected end of regex")
        if tok[0] == "SYM":
            self.eat("SYM")
            return Sym(tok[1])
        if tok[0] == "EPS":
            self.eat("EPS")
            return Eps()
        if tok[0] == "LPAR":
            self.eat("LPAR")
            if self.peek() is not None and self.peek()[0] == "RPAR":
                self.eat("RPAR")
                return Eps()
            node = self.alternation()
            self.eat("RPAR")
            return node
        raise ValueError(f"unexpected token {tok}")


def parse(src: str) -> Node:
    """Parse an RPQ regular expression string into an AST."""
    return _Parser(list(_tokenize(src))).parse()
