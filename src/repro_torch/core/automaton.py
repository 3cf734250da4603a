"""Query-registration machinery: regex -> NFA -> minimal DFA (+ RSPQ metadata).

Pipeline (paper §2): Thompson's construction builds an NFA for ``L(R)``;
subset construction determinizes; Hopcroft's algorithm minimizes. For RSPQ
(§4) we additionally compute, per DFA state, the *suffix language* containment
relation ``C[s, t] = ([s] ⊇ [t])`` (Definition 14/15) used for conflict
detection (Definition 16), and decide whether the automaton itself has the
suffix-language containment property (which implies conflict-freedom on every
graph, the tractable Mendelzon–Wood class).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import regex as rx


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------

EPS = None  # epsilon transition marker


@dataclasses.dataclass
class NFA:
    n_states: int
    start: int
    accept: int
    # transitions: list of (src, label-or-None, dst)
    edges: List[Tuple[int, Optional[str], int]]


def thompson(node: rx.Node) -> NFA:
    """Thompson's construction [65]: one start, one accept, eps-transitions."""
    counter = itertools.count()
    edges: List[Tuple[int, Optional[str], int]] = []

    def fresh() -> int:
        return next(counter)

    def build(n: rx.Node) -> Tuple[int, int]:
        if isinstance(n, rx.Eps):
            s, t = fresh(), fresh()
            edges.append((s, EPS, t))
            return s, t
        if isinstance(n, rx.Sym):
            s, t = fresh(), fresh()
            edges.append((s, n.label, t))
            return s, t
        if isinstance(n, rx.Cat):
            ls, lt = build(n.left)
            rs, rt = build(n.right)
            edges.append((lt, EPS, rs))
            return ls, rt
        if isinstance(n, rx.Alt):
            ls, lt = build(n.left)
            rs, rt = build(n.right)
            s, t = fresh(), fresh()
            edges.extend([(s, EPS, ls), (s, EPS, rs), (lt, EPS, t), (rt, EPS, t)])
            return s, t
        if isinstance(n, rx.Star):
            is_, it = build(n.inner)
            s, t = fresh(), fresh()
            edges.extend([(s, EPS, is_), (it, EPS, t), (s, EPS, t), (it, EPS, is_)])
            return s, t
        if isinstance(n, rx.Plus):
            is_, it = build(n.inner)
            s, t = fresh(), fresh()
            edges.extend([(s, EPS, is_), (it, EPS, t), (it, EPS, is_)])
            return s, t
        if isinstance(n, rx.Opt):
            is_, it = build(n.inner)
            s, t = fresh(), fresh()
            edges.extend([(s, EPS, is_), (it, EPS, t), (s, EPS, t)])
            return s, t
        raise TypeError(f"unknown node {n!r}")

    start, accept = build(node)
    return NFA(n_states=next(counter), start=start, accept=accept, edges=edges)


# ---------------------------------------------------------------------------
# Subset construction + Hopcroft minimization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DFA:
    """Deterministic finite automaton over the query's label alphabet.

    ``delta`` is a dense ``(k, L)`` int array; ``-1`` encodes "no transition"
    (we keep a partial DFA: the dead state is implicit, which keeps the
    product graph small — the paper's traversal likewise never materializes
    dead product nodes).
    """

    labels: Tuple[str, ...]              # alphabet Sigma_Q, sorted
    delta: np.ndarray                    # (k, L) int32, -1 = undefined
    start: int                           # s0 (always 0 after canonicalization)
    finals: FrozenSet[int]               # F
    # RSPQ metadata (filled by `with_rspq_metadata`):
    containment: Optional[np.ndarray] = None  # (k, k) bool: [s] ⊇ [t]
    has_containment_property: Optional[bool] = None

    @property
    def k(self) -> int:
        return int(self.delta.shape[0])

    @property
    def n_labels(self) -> int:
        return int(self.delta.shape[1])

    def label_index(self, label: str) -> int:
        return self.labels.index(label)

    def step(self, state: int, label: str) -> int:
        """delta(s, a); -1 when undefined (dead)."""
        if label not in self.labels:
            return -1
        return int(self.delta[state, self.labels.index(label)])

    def accepts(self, word: Sequence[str]) -> bool:
        s = self.start
        for a in word:
            s = self.step(s, a)
            if s < 0:
                return False
        return s in self.finals

    def accepts_empty(self) -> bool:
        return self.start in self.finals

    def transitions(self) -> List[Tuple[int, int, int]]:
        """All defined transitions as (s, label_idx, t)."""
        out = []
        for s in range(self.k):
            for li in range(self.n_labels):
                t = int(self.delta[s, li])
                if t >= 0:
                    out.append((s, li, t))
        return out


def _eps_closure(states: Set[int], eps_adj: Dict[int, List[int]]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in eps_adj.get(s, ()):  # epsilon edges
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def determinize(nfa: NFA, labels: Sequence[str]) -> DFA:
    labels = tuple(sorted(labels))
    eps_adj: Dict[int, List[int]] = {}
    lab_adj: Dict[Tuple[int, str], List[int]] = {}
    for s, a, t in nfa.edges:
        if a is EPS:
            eps_adj.setdefault(s, []).append(t)
        else:
            lab_adj.setdefault((s, a), []).append(t)

    start = _eps_closure({nfa.start}, eps_adj)
    index: Dict[FrozenSet[int], int] = {start: 0}
    order: List[FrozenSet[int]] = [start]
    delta_rows: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = []
        for a in labels:
            nxt: Set[int] = set()
            for s in cur:
                nxt.update(lab_adj.get((s, a), ()))
            if not nxt:
                row.append(-1)
            else:
                closed = _eps_closure(nxt, eps_adj)
                if closed not in index:
                    index[closed] = len(order)
                    order.append(closed)
                row.append(index[closed])
        delta_rows.append(row)
        i += 1

    finals = frozenset(i for i, ss in enumerate(order) if nfa.accept in ss)
    delta = np.asarray(delta_rows, dtype=np.int32).reshape(len(order), len(labels))
    return DFA(labels=labels, delta=delta, start=0, finals=finals)


def _reachable(delta: np.ndarray, start: int) -> Set[int]:
    k, L = delta.shape
    seen = {start}
    stack = [start]
    while stack:
        s = stack.pop()
        for li in range(L):
            t = int(delta[s, li])
            if t >= 0 and t not in seen:
                seen.add(t)
                stack.append(t)
    return seen


def _coreachable(delta: np.ndarray, finals: FrozenSet[int]) -> Set[int]:
    k, L = delta.shape
    rev: Dict[int, Set[int]] = {}
    for s in range(k):
        for li in range(L):
            t = int(delta[s, li])
            if t >= 0:
                rev.setdefault(t, set()).add(s)
    seen = set(finals)
    stack = list(finals)
    while stack:
        s = stack.pop()
        for p in rev.get(s, ()):  # predecessors
            if p not in seen:
                seen.add(p)
                stack.append(p)
    return seen


def _trim(dfa: DFA) -> DFA:
    """Remove states not on a path start -> final (keeps the DFA partial)."""
    useful = _reachable(dfa.delta, dfa.start) & _coreachable(dfa.delta, dfa.finals)
    if not useful:
        # empty language: single non-final start state, no transitions
        return DFA(
            labels=dfa.labels,
            delta=np.full((1, dfa.n_labels), -1, dtype=np.int32),
            start=0,
            finals=frozenset(),
        )
    remap = {s: i for i, s in enumerate(sorted(useful, key=lambda s: (s != dfa.start, s)))}
    k = len(remap)
    delta = np.full((k, dfa.n_labels), -1, dtype=np.int32)
    for s, li, t in dfa.transitions():
        if s in remap and t in remap:
            delta[remap[s], li] = remap[t]
    finals = frozenset(remap[s] for s in dfa.finals if s in remap)
    return DFA(labels=dfa.labels, delta=delta, start=remap[dfa.start], finals=finals)


def hopcroft_minimize(dfa: DFA) -> DFA:
    """Hopcroft's O(k log k) DFA minimization [41] on the completed DFA,
    then re-trim to a partial DFA."""
    # Complete the DFA with an explicit dead state so Hopcroft applies.
    k = dfa.k
    L = dfa.n_labels
    dead = k
    delta = np.full((k + 1, L), dead, dtype=np.int32)
    delta[:k] = np.where(dfa.delta >= 0, dfa.delta, dead)
    finals = set(dfa.finals)

    # Initial partition: finals / non-finals.
    P: List[Set[int]] = []
    f = set(finals)
    nf = set(range(k + 1)) - f
    if f:
        P.append(f)
    if nf:
        P.append(nf)
    W: List[Set[int]] = [set(min(P, key=len))] if len(P) > 1 else list(map(set, P))

    # Precompute inverse transitions.
    inv: List[Dict[int, Set[int]]] = [dict() for _ in range(L)]
    for s in range(k + 1):
        for li in range(L):
            inv[li].setdefault(int(delta[s, li]), set()).add(s)

    while W:
        A = W.pop()
        for li in range(L):
            X = set()
            for t in A:
                X |= inv[li].get(t, set())
            if not X:
                continue
            newP: List[Set[int]] = []
            for Y in P:
                inter = Y & X
                diff = Y - X
                if inter and diff:
                    newP.extend([inter, diff])
                    if Y in W:
                        W.remove(Y)
                        W.extend([inter, diff])
                    else:
                        W.append(min(inter, diff, key=len))
                else:
                    newP.append(Y)
            P = newP

    block_of = {}
    for bi, block in enumerate(P):
        for s in block:
            block_of[s] = bi
    kk = len(P)
    mdelta = np.full((kk, L), -1, dtype=np.int32)
    for bi, block in enumerate(P):
        rep = next(iter(block))
        for li in range(L):
            mdelta[bi, li] = block_of[int(delta[rep, li])]
    mstart = block_of[dfa.start]
    mfinals = frozenset(block_of[s] for s in finals)
    merged = DFA(labels=dfa.labels, delta=mdelta, start=mstart, finals=mfinals)
    trimmed = _trim(merged)
    # Canonicalize state order by BFS from start for determinism.
    return _canonicalize(trimmed)


def _canonicalize(dfa: DFA) -> DFA:
    order: List[int] = [dfa.start]
    seen = {dfa.start}
    i = 0
    while i < len(order):
        s = order[i]
        for li in range(dfa.n_labels):
            t = int(dfa.delta[s, li])
            if t >= 0 and t not in seen:
                seen.add(t)
                order.append(t)
        i += 1
    # unreachable-from-start states were already trimmed
    remap = {s: i for i, s in enumerate(order)}
    k = len(order)
    delta = np.full((k, dfa.n_labels), -1, dtype=np.int32)
    for s, li, t in dfa.transitions():
        delta[remap[s], li] = remap[t]
    return DFA(
        labels=dfa.labels,
        delta=delta,
        start=0,
        finals=frozenset(remap[s] for s in dfa.finals),
        containment=None,
        has_containment_property=None,
    )


# ---------------------------------------------------------------------------
# RSPQ metadata: suffix languages & containment (Definitions 14-16)
# ---------------------------------------------------------------------------


def suffix_containment(dfa: DFA) -> np.ndarray:
    """C[s, t] = True iff [s] ⊇ [t] (suffix language of s contains that of t).

    [s] ⊇ [t]  ⟺  L(A; start=t) ⊆ L(A; start=s). Decided by the standard
    product construction: explore pairs (p, q) from (t, s); a witness word in
    [t] \\ [s] exists iff some reachable pair has p final and q non-final
    (or q dead). Partial-DFA convention: a dead q rejects everything.
    """
    k, L = dfa.delta.shape
    C = np.zeros((k, k), dtype=bool)
    for s in range(k):
        for t in range(k):
            C[s, t] = _subset_of(dfa, t, s)
    return C


def _subset_of(dfa: DFA, t: int, s: int) -> bool:
    """True iff L(start=t) ⊆ L(start=s)."""
    k, L = dfa.delta.shape
    DEAD = -1
    start = (t, s)
    seen = {start}
    stack = [start]
    finals = dfa.finals
    while stack:
        p, q = stack.pop()
        if p in finals and (q == DEAD or q not in finals):
            return False
        for li in range(L):
            pn = int(dfa.delta[p, li]) if p != DEAD else DEAD
            if pn == DEAD:
                continue  # word leaves L(t): no containment obligation
            qn = int(dfa.delta[q, li]) if q != DEAD else DEAD
            nxt = (pn, qn)
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return True


def containment_property(dfa: DFA, C: np.ndarray) -> bool:
    """Definition 15: for every pair (s, t) on a path s0 -> final with t a
    successor of s (t reachable from s by >=1 transition), require [s] ⊇ [t].

    After `_trim`, every state is on a start->final path, so we only need
    reachability between states.
    """
    k = dfa.k
    # successor relation: t reachable from s via >= 1 transitions
    reach = np.zeros((k, k), dtype=bool)
    for s, _, t in dfa.transitions():
        reach[s, t] = True
    # transitive closure (k is tiny)
    for m in range(k):
        reach = reach | (reach[:, m : m + 1] & reach[m : m + 1, :])
    for s in range(k):
        for t in range(k):
            if reach[s, t] and not C[s, t]:
                return False
    return True


def with_rspq_metadata(dfa: DFA) -> DFA:
    C = suffix_containment(dfa)
    prop = containment_property(dfa, C)
    return dataclasses.replace(dfa, containment=C, has_containment_property=prop)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def compile_query(expr: str, extra_labels: Sequence[str] = ()) -> DFA:
    """Compile an RPQ regex into a minimal DFA with RSPQ metadata.

    ``extra_labels`` lets callers widen the alphabet (e.g. to a shared graph
    alphabet) without changing the language.
    """
    ast = rx.parse(expr)
    labels = sorted(ast.labels() | set(extra_labels))
    nfa = thompson(ast)
    dfa = determinize(nfa, labels)
    dfa = hopcroft_minimize(dfa)
    return with_rspq_metadata(dfa)
