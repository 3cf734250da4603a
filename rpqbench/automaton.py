"""The reference's own query compiler: a path regex over edge labels ->
the minimal partial DFA, numbered canonically, with the suffix-language
containment relation that simple-path semantics needs.

Syntax: labels (identifiers), ``.`` concatenation, ``|`` alternation,
postfix ``*``, ``+`` and ``?``, parentheses. The DFA is trimmed (every
state reaches a final state; a missing transition is the implicit dead
state) and its states are numbered in breadth-first order from the start
over the sorted labels, so two compilers that both minimise number the
states alike.
"""
from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

_TOKEN = re.compile(r"\s*(?:([A-Za-z_][A-Za-z0-9_]*)|(.))")


def _tokens(expr: str) -> List[str]:
    out = []
    pos = 0
    expr = expr.strip()
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if m is None:
            break
        out.append(m.group(1) or m.group(2))
        pos = m.end()
    return [t for t in out if t.strip()]


class _Parser:
    """Recursive descent to a Thompson NFA fragment (start, accept)."""

    def __init__(self, expr: str):
        self.toks = _tokens(expr)
        self.i = 0
        self.edges: List[Tuple[int, Optional[str], int]] = []
        self.n = 0

    def _new(self) -> int:
        self.n += 1
        return self.n - 1

    def _peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def parse(self) -> Tuple[int, int]:
        frag = self._alt()
        if self._peek() is not None:
            raise ValueError(f"unexpected {self._peek()!r}")
        return frag

    def _alt(self) -> Tuple[int, int]:
        frag = self._cat()
        while self._peek() == "|":
            self.i += 1
            right = self._cat()
            s, a = self._new(), self._new()
            self.edges += [(s, None, frag[0]), (s, None, right[0]),
                           (frag[1], None, a), (right[1], None, a)]
            frag = (s, a)
        return frag

    def _cat(self) -> Tuple[int, int]:
        frag = self._post()
        while self._peek() == ".":
            self.i += 1
            right = self._post()
            self.edges.append((frag[1], None, right[0]))
            frag = (frag[0], right[1])
        return frag

    def _post(self) -> Tuple[int, int]:
        frag = self._atom()
        while self._peek() in ("*", "+", "?"):
            op = self._peek()
            self.i += 1
            s, a = self._new(), self._new()
            self.edges += [(s, None, frag[0]), (frag[1], None, a)]
            if op in ("*", "?"):
                self.edges.append((s, None, a))
            if op in ("*", "+"):
                self.edges.append((frag[1], None, frag[0]))
            frag = (s, a)
        return frag

    def _atom(self) -> Tuple[int, int]:
        tok = self._peek()
        if tok == "(":
            self.i += 1
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("missing ')'")
            self.i += 1
            return frag
        if tok is None or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", tok):
            raise ValueError(f"expected a label, got {tok!r}")
        self.i += 1
        s, a = self._new(), self._new()
        self.edges.append((s, tok, a))
        return (s, a)


class Dfa:
    """A minimal partial DFA: ``delta`` (k, L) int, -1 where undefined."""

    def __init__(self, labels: Tuple[str, ...], delta: np.ndarray,
                 finals: FrozenSet[int]):
        self.labels = labels
        self.delta = delta
        self.start = 0
        self.finals = finals
        self.containment = _containment(delta, finals)   # [s] ⊇ [t]
        reach = delta_reach(delta)
        self.has_containment_property = bool(
            np.all(self.containment[reach]))

    @property
    def k(self) -> int:
        return int(self.delta.shape[0])

    def transitions(self) -> List[Tuple[int, int, int]]:
        """Every defined transition as (s, label index, t)."""
        return [(s, li, int(self.delta[s, li]))
                for s in range(self.k) for li in range(len(self.labels))
                if self.delta[s, li] >= 0]

    def key(self) -> Tuple:
        return (self.labels, self.delta.tobytes(), self.delta.shape,
                tuple(sorted(self.finals)))


def delta_reach(delta: np.ndarray) -> np.ndarray:
    """(k, k) bool: t reachable from s by one or more transitions."""
    k = delta.shape[0]
    reach = np.zeros((k, k), bool)
    for s in range(k):
        for t in delta[s]:
            if t >= 0:
                reach[s, t] = True
    for m in range(k):
        reach |= reach[:, m:m + 1] & reach[m:m + 1, :]
    return reach


def _containment(delta: np.ndarray, finals: FrozenSet[int]) -> np.ndarray:
    """C[s, t]: the suffix language of s contains that of t, decided on the
    pair automaton from (t, s) (-1 is the dead state)."""
    k, n_labels = delta.shape
    out = np.ones((k, k), bool)
    for s in range(k):
        for t in range(k):
            seen = {(t, s)}
            stack = [(t, s)]
            while stack:
                p, q = stack.pop()
                if p in finals and (q < 0 or q not in finals):
                    out[s, t] = False
                    break
                for li in range(n_labels):
                    pn = int(delta[p, li])
                    if pn < 0:
                        continue
                    qn = int(delta[q, li]) if q >= 0 else -1
                    if (pn, qn) not in seen:
                        seen.add((pn, qn))
                        stack.append((pn, qn))
    return out


def compile_query(expr: str) -> Dfa:
    """``expr`` -> the minimal, trimmed, canonically numbered DFA."""
    parser = _Parser(expr)
    start, accept = parser.parse()
    labels = tuple(sorted({lab for (_s, lab, _t) in parser.edges if lab}))
    eps: Dict[int, List[int]] = {}
    sym: Dict[Tuple[int, str], List[int]] = {}
    for s, lab, t in parser.edges:
        if lab is None:
            eps.setdefault(s, []).append(t)
        else:
            sym.setdefault((s, lab), []).append(t)

    def closure(states) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            for t in eps.get(stack.pop(), ()):
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    # subset construction (reachable subsets only)
    first = closure([start])
    index = {first: 0}
    order = [first]
    trans: List[List[int]] = []
    i = 0
    while i < len(order):
        row = []
        for lab in labels:
            nxt = closure([t for s in order[i] for t in sym.get((s, lab), ())])
            if not nxt:
                row.append(-1)
                continue
            if nxt not in index:
                index[nxt] = len(order)
                order.append(nxt)
            row.append(index[nxt])
        trans.append(row)
        i += 1
    finals = {j for j, subset in enumerate(order) if accept in subset}
    delta = np.array(trans, dtype=np.int64).reshape(len(order), len(labels))

    # trim: keep the states that reach a final state
    live = set(finals)
    changed = True
    while changed:
        changed = False
        for s in range(len(order)):
            if s not in live and any(t in live for t in delta[s] if t >= 0):
                live.add(s)
                changed = True
    if 0 not in live:
        raise ValueError(f"{expr!r} accepts no word")

    # minimise: Moore refinement on the live states (dead = class -1)
    cls = {s: int(s in finals) for s in live}
    while True:
        sig = {s: (cls[s],) + tuple(cls.get(int(t), -1) if t >= 0 else -1
                                    for t in delta[s]) for s in live}
        ids: Dict[Tuple, int] = {}
        new = {s: ids.setdefault(sig[s], len(ids)) for s in sorted(live)}
        if len(ids) == len(set(cls.values())):
            cls = new
            break
        cls = new

    # canonical numbering: breadth first from the start over sorted labels
    rep = {}
    for s in sorted(live):
        rep.setdefault(cls[s], s)
    number = {cls[0]: 0}
    queue = [cls[0]]
    rows: List[List[int]] = []
    j = 0
    while j < len(queue):
        c = queue[j]
        row = []
        for li in range(len(labels)):
            t = int(delta[rep[c], li])
            if t < 0 or t not in live:
                row.append(-1)
                continue
            ct = cls[t]
            if ct not in number:
                number[ct] = len(queue)
                queue.append(ct)
            row.append(number[ct])
        rows.append(row)
        j += 1
    out_finals = frozenset(number[cls[s]] for s in finals if s in live)
    return Dfa(labels, np.array(rows, dtype=np.int64).reshape(len(rows), len(labels)),
               out_finals)

