"""Paper-faithful reference implementation of the streaming RPQ algorithms.

This module transcribes the paper's pseudocode (Algorithms RAPQ, Insert,
ExpiryRAPQ, Delete — §3; RSPQ, Extend, Unmark, ExpiryRSPQ — §4) into plain
Python with pointer-based spanning trees. It serves two roles:

1. the *paper-faithful baseline* measured in benchmarks (vs the dense
   engine), and
2. the *correctness oracle* for the dense engine and its CUDA kernel
   (the service's reference engines answer the same queries beside the
   dense group, and ``chip_smoke.py`` compares the two result sets).

This module is a copy of ``repro.core.reference`` (the JAX package's
oracle); the port keeps its own so importing it never loads JAX.

Conventions
-----------
* vertices are hashable ids; labels are strings; timestamps are floats.
* "node" = (vertex, state) occurrence in a spanning tree (paper wording).
* RAPQ keeps exactly one occurrence per (v, t) per tree (Lemma 1, inv. 2);
  RSPQ may keep several when conflicts force re-traversals (§4.1).
* Implicit window model: the result *stream* is append-only; explicit
  deletions / expiry can invalidate (reported separately, §3.2).

Where the paper's pseudocode is ambiguous we document the choice inline and
validate the result sets against the brute-force algorithms in
``core/batch.py`` (see tests/test_reference_vs_batch.py).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from .automaton import DFA

NEG_INF = float("-inf")
POS_INF = float("inf")

Vertex = object  # hashable
Pair = Tuple[object, object]


class SnapshotGraph:
    """The window content G_{W,tau}: newest timestamp per (u, v, label)."""

    def __init__(self) -> None:
        self.edge_ts: Dict[Tuple[object, object, str], float] = {}
        self.out_adj: Dict[object, Dict[Tuple[object, str], float]] = {}
        self.in_adj: Dict[object, Dict[Tuple[object, str], float]] = {}

    def upsert(self, u: object, v: object, label: str, ts: float) -> None:
        key = (u, v, label)
        old = self.edge_ts.get(key, NEG_INF)
        if ts >= old:
            self.edge_ts[key] = ts
            self.out_adj.setdefault(u, {})[(v, label)] = ts
            self.in_adj.setdefault(v, {})[(u, label)] = ts

    def remove(self, u: object, v: object, label: str) -> bool:
        key = (u, v, label)
        if key not in self.edge_ts:
            return False
        del self.edge_ts[key]
        self.out_adj.get(u, {}).pop((v, label), None)
        self.in_adj.get(v, {}).pop((u, label), None)
        return True

    def prune(self, low: float) -> None:
        """Drop edges with ts <= low (window maintenance, lazy)."""
        dead = [k for k, ts in self.edge_ts.items() if ts <= low]
        for (u, v, label) in dead:
            self.remove(u, v, label)

    def out_edges(self, u: object) -> Iterable[Tuple[object, str, float]]:
        for (v, label), ts in self.out_adj.get(u, {}).items():
            yield v, label, ts

    def in_edges(self, v: object) -> Iterable[Tuple[object, str, float]]:
        for (u, label), ts in self.in_adj.get(v, {}).items():
            yield u, label, ts

    def n_edges(self) -> int:
        return len(self.edge_ts)

    def vertices(self) -> Set[object]:
        vs: Set[object] = set()
        for (u, v, _l) in self.edge_ts:
            vs.add(u)
            vs.add(v)
        return vs


class _Occ:
    """A spanning-tree node occurrence: (vertex, state) + parent pointer + ts.

    (paper: ``(u, s).pt`` and ``(u, s).ts``, Definition 12.)
    """

    __slots__ = ("vertex", "state", "ts", "parent", "children")

    def __init__(self, vertex: object, state: int, ts: float, parent: Optional["_Occ"]):
        self.vertex = vertex
        self.state = state
        self.ts = ts
        self.parent = parent
        self.children: Set["_Occ"] = set()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Occ({self.vertex},{self.state},ts={self.ts})"


class _Tree:
    """Spanning tree T_x rooted at (x, s0) with a hash index on (v, t)."""

    def __init__(self, root_vertex: object, start_state: int):
        self.x = root_vertex
        self.root = _Occ(root_vertex, start_state, POS_INF, None)
        # RAPQ: exactly one occurrence per (v, t); RSPQ uses _MultiTree below.
        self.index: Dict[Tuple[object, int], _Occ] = {
            (root_vertex, start_state): self.root
        }

    def get(self, v: object, t: int) -> Optional[_Occ]:
        return self.index.get((v, t))

    def states_at(self, v: object) -> List[int]:
        return [s for (u, s) in self.index if u == v]

    def n_nodes(self) -> int:
        return len(self.index)


class RAPQ:
    """Algorithm RAPQ (§3.1) + ExpiryRAPQ (§3.1) + Delete (§3.2).

    Usage: feed tuples in timestamp order via :meth:`insert` /
    :meth:`delete`; call :meth:`expire` at slide boundaries (the driver in
    ``streaming/service.py`` follows eager evaluation / lazy expiration,
    exactly the paper's setting).
    """

    def __init__(self, dfa: DFA, window: float):
        if dfa.containment is None:
            raise ValueError("compile the query with with_rspq_metadata/compile_query")
        self.dfa = dfa
        self.window = float(window)
        self.graph = SnapshotGraph()
        self.delta: Dict[object, _Tree] = {}  # the Δ tree index
        # reverse index: vertex -> set of tree roots whose tree contains it
        self.occurs_in: Dict[object, Set[object]] = {}
        self.results: Set[Pair] = set()       # the (monotone) result set
        self.result_log: List[Tuple[float, Pair]] = []  # append-only stream
        self.now: float = NEG_INF
        # per-label transition lists: label_idx -> [(s, t)]
        self._trans_by_label: Dict[int, List[Tuple[int, int]]] = {}
        for s, li, t in dfa.transitions():
            self._trans_by_label.setdefault(li, []).append((s, t))

    # -- bookkeeping ------------------------------------------------------

    def _low(self) -> float:
        return self.now - self.window

    def _emit(self, x: object, v: object) -> None:
        # implicit-window semantics: the result is a monotone SET (Def. 9);
        # re-derivations of an already-reported pair are not re-emitted
        pair = (x, v)
        if pair in self.results:
            return
        self.results.add(pair)
        self.result_log.append((self.now, pair))

    def _track(self, vertex: object, tree: _Tree) -> None:
        self.occurs_in.setdefault(vertex, set()).add(tree.x)

    # -- Algorithm Insert --------------------------------------------------

    def _insert(self, tree: _Tree, parent: _Occ, v: object, t: int,
                edge_ts: float, reinserted: Optional[Set[Tuple[object, int]]] = None) -> None:
        """Algorithm Insert: attach/improve (v, t) under ``parent``.

        Improvement case (paper Insert line 8 / RAPQ line 10): when (v, t)
        already exists with a *worse* timestamp we re-parent it and propagate
        the improvement; the strict ``<`` makes cycles impossible because a
        descendant's ts can never strictly exceed its ancestor's.
        """
        nts = min(edge_ts, parent.ts)
        if nts <= self._low():
            return  # stale path: outside window (paper gates on validity)
        occ = tree.get(v, t)
        if occ is tree.root:
            # a length>=1 cycle back to (x, s0): a genuine (x, x) answer when
            # s0 is final, but the root node itself is never re-expanded
            if t in self.dfa.finals:
                self._emit(tree.x, v)
            return
        if occ is None:
            occ = _Occ(v, t, nts, parent)
            parent.children.add(occ)
            tree.index[(v, t)] = occ
            self._track(v, tree)
            if reinserted is not None:
                reinserted.add((v, t))
            if t in self.dfa.finals:
                self._emit(tree.x, v)
        elif occ.ts < nts:
            # re-parent with improved (larger) bottleneck timestamp
            if occ.parent is not None:
                occ.parent.children.discard(occ)
            occ.parent = parent
            parent.children.add(occ)
            occ.ts = nts
            if reinserted is not None:
                reinserted.add((v, t))
        else:
            return  # no improvement: prune (Lemma 1 invariant 2)
        # recurse over window edges out of v (Insert lines 7-11)
        for w, label, ets in list(self.graph.out_edges(v)):
            if ets <= self._low():
                continue
            li = self.dfa.labels.index(label) if label in self.dfa.labels else -1
            if li < 0:
                continue
            q = int(self.dfa.delta[t, li])
            if q < 0:
                continue
            child = tree.get(w, q)
            cand = min(occ.ts, ets)
            # `child is tree.root`: cycles back to (x, s0) are reported (not
            # expanded) inside _insert — a genuine (x, x) answer when s0 ∈ F
            if child is None or child is tree.root or child.ts < cand:
                self._insert(tree, occ, w, q, ets, reinserted)

    # -- Algorithm RAPQ (per arriving + tuple) ------------------------------

    def insert(self, u: object, v: object, label: str, ts: float) -> Set[Pair]:
        """Process an append tuple (ts, (u, v), label, +). Returns new pairs."""
        self.now = max(self.now, ts)
        before = len(self.result_log)
        if label not in self.dfa.labels:
            return set()  # tuple label outside Sigma_Q: discarded (§5.2)
        self.graph.upsert(u, v, label, ts)
        li = self.dfa.labels.index(label)
        low = self._low()
        for (s, t) in self._trans_by_label.get(li, ()):  # all (s,l)->t
            if s == self.dfa.start:
                # ensure the tree rooted at (u, s0) exists (Definition 12)
                tree = self.delta.get(u)
                if tree is None:
                    tree = _Tree(u, self.dfa.start)
                    self.delta[u] = tree
                    self._track(u, tree)
                self._insert(tree, tree.root, v, t, ts)
            # all trees that contain (u, s) extend with (v, t)
            for x in list(self.occurs_in.get(u, ())):
                tree = self.delta.get(x)
                if tree is None:
                    continue
                parent = tree.get(u, s)
                if parent is None or parent.ts <= low:
                    continue
                child = tree.get(v, t)
                cand = min(parent.ts, ts)
                if child is None or child is tree.root or child.ts < cand:
                    self._insert(tree, parent, v, t, ts)
        return {p for (_ts, p) in self.result_log[before:]}

    # -- Algorithm ExpiryRAPQ ----------------------------------------------

    def expire(self, tau: Optional[float] = None) -> Set[Pair]:
        """Remove nodes whose ts fell out of the window; try to reconnect.

        Returns the set of *invalidated* results (only meaningful under
        explicit windows / explicit deletions, §3.2).
        """
        if tau is not None:
            self.now = max(self.now, tau)
        low = self._low()
        invalidated: Set[Pair] = set()
        self.graph.prune(low)
        for x, tree in list(self.delta.items()):
            inv = self._expire_tree(tree, low)
            invalidated |= inv
            if tree.n_nodes() <= 1 and not self._root_live(tree, low):
                # only the root remains and no valid start edge: drop tree
                del self.delta[x]
                occs = self.occurs_in.get(x)
                if occs is not None:
                    occs.discard(x)
        return invalidated

    def _root_live(self, tree: _Tree, low: float) -> bool:
        """True if the root still has a valid out-edge on a start transition
        (covers self-loop-only trees, whose only non-root node IS the root)."""
        for v, label, ets in self.graph.out_edges(tree.x):
            if ets <= low or label not in self.dfa.labels:
                continue
            li = self.dfa.labels.index(label)
            if any(s == self.dfa.start for (s, _t) in self._trans_by_label.get(li, ())):
                return True
        return False

    def _expire_tree(self, tree: _Tree, low: float) -> Set[Pair]:
        # Line 2: potentially expired nodes
        P = {(v, t) for (v, t), occ in tree.index.items()
             if occ.ts <= low and occ is not tree.root}
        if not P:
            return set()
        # Line 3: prune T_x (detach whole set; descendants of expired nodes
        # are provably expired too -- see DESIGN.md validation notes)
        for key in P:
            occ = tree.index.pop(key)
            if occ.parent is not None:
                occ.parent.children.discard(occ)
            occ.parent = None
            occs = self.occurs_in.get(key[0])
            if occs is not None and not any(
                key[0] == vv for (vv, _s) in tree.index
            ):
                occs.discard(tree.x)
        # Lines 4-10: reconnect via valid in-edges from surviving nodes
        reinserted: Set[Tuple[object, int]] = set()
        for (v, t) in list(P):
            if (v, t) in reinserted:
                continue
            for u, label, ets in list(self.graph.in_edges(v)):
                if ets <= low or label not in self.dfa.labels:
                    continue
                li = self.dfa.labels.index(label)
                for (s, tt) in self._trans_by_label.get(li, ()):  # (u,s)->(v,t)
                    if tt != t:
                        continue
                    parent = tree.get(u, s) if (u, s) != (tree.x, self.dfa.start) else tree.root
                    if parent is None or parent.ts <= low:
                        continue
                    self._insert(tree, parent, v, t, ets, reinserted)
        # Lines 11-15: results invalidated by permanent removals
        invalidated: Set[Pair] = set()
        for (v, t) in P - reinserted:
            if t in self.dfa.finals:
                # refinement over the paper's line 13: only invalidate when no
                # other valid accepting occurrence of v remains in this tree
                if not any(
                    tree.get(v, tf) is not None and tree.get(v, tf).ts > low
                    for tf in self.dfa.finals
                ):
                    invalidated.add((tree.x, v))
        return invalidated

    # -- Algorithm Delete (negative tuples, §3.2) ---------------------------

    def delete(self, u: object, v: object, label: str, ts: float) -> Set[Pair]:
        """Process an explicit deletion tuple (ts, (u, v), label, -)."""
        self.now = max(self.now, ts)
        if not self.graph.remove(u, v, label):
            return set()
        if label not in self.dfa.labels:
            return set()
        li = self.dfa.labels.index(label)
        low = self._low()
        invalidated: Set[Pair] = set()
        for x in list(self.delta.keys()):
            tree = self.delta[x]
            touched = False
            for (s, t) in self._trans_by_label.get(li, ()):  # tree-edge test
                child = tree.get(v, t)
                if child is None or child.parent is None:
                    continue
                par = child.parent
                if par.vertex == u and par.state == s:
                    # deleted edge is a tree edge: poison the subtree
                    self._poison(child)
                    touched = True
            if touched:
                invalidated |= self._expire_tree(tree, low)
        return invalidated

    @staticmethod
    def _poison(occ: _Occ) -> None:
        stack = [occ]
        while stack:
            o = stack.pop()
            o.ts = NEG_INF
            stack.extend(o.children)

    # -- introspection -----------------------------------------------------

    def current_results(self) -> Set[Pair]:
        """Result set of the *current* snapshot (explicit-window view):
        pairs with a currently valid accepting node."""
        low = self._low()
        out: Set[Pair] = set()
        for x, tree in self.delta.items():
            for (v, t), occ in tree.index.items():
                if t in self.dfa.finals and occ.ts > low and occ is not tree.root:
                    out.add((x, v))
            # diagonal answers (x, x): a valid cycle closing back into the
            # root (x, s0) through an accepting transition
            if (x, x) not in out:
                for u, label, ets in self.graph.in_edges(x):
                    if ets <= low or label not in self.dfa.labels:
                        continue
                    li = self.dfa.labels.index(label)
                    for (s, t) in self._trans_by_label.get(li, ()):
                        if t not in self.dfa.finals:
                            continue
                        node = tree.get(u, s)
                        if node is not None and min(node.ts, ets) > low:
                            out.add((x, x))
                            break
                    if (x, x) in out:
                        break
        return out

    def index_size(self) -> Tuple[int, int]:
        """(number of trees, total nodes) — Fig. 5 metric."""
        trees = len(self.delta)
        nodes = sum(t.n_nodes() for t in self.delta.values())
        return trees, nodes


# ===========================================================================
# RSPQ (§4): simple path semantics with conflict detection
# ===========================================================================


class _SOcc:
    """RSPQ occurrence: same as _Occ but multiple occurrences of a (v, t)
    pair may coexist in one tree when conflicts force re-traversal."""

    __slots__ = ("vertex", "state", "ts", "parent", "children")

    def __init__(self, vertex: object, state: int, ts: float, parent):
        self.vertex = vertex
        self.state = state
        self.ts = ts
        self.parent = parent
        self.children: Set["_SOcc"] = set()


class _STree:
    def __init__(self, root_vertex: object, start_state: int):
        self.x = root_vertex
        self.root = _SOcc(root_vertex, start_state, POS_INF, None)
        self.occs: Dict[Tuple[object, int], List[_SOcc]] = {
            (root_vertex, start_state): [self.root]
        }
        self.markings: Set[Tuple[object, int]] = set()  # M_x

    def all_occs(self, v: object, t: int) -> List[_SOcc]:
        return self.occs.get((v, t), [])

    def add(self, occ: _SOcc) -> None:
        self.occs.setdefault((occ.vertex, occ.state), []).append(occ)

    def remove(self, occ: _SOcc) -> None:
        lst = self.occs.get((occ.vertex, occ.state))
        if lst is not None:
            try:
                lst.remove(occ)
            except ValueError:
                pass
            if not lst:
                del self.occs[(occ.vertex, occ.state)]

    def n_nodes(self) -> int:
        return sum(len(v) for v in self.occs.values())


def _path_of(occ: _SOcc) -> List[_SOcc]:
    out = []
    cur = occ
    while cur is not None:
        out.append(cur)
        cur = cur.parent
    out.reverse()
    return out


class RSPQ:
    """Algorithm RSPQ (§4.1): Extend + Unmark + ExpiryRSPQ.

    Efficient (polynomial) in the absence of conflicts; may re-traverse
    (exponential worst case) when conflicts appear — matching the paper's
    complexity statement (Theorem 5). ``max_extend_budget`` caps runaway
    conflicted traversals for benchmark safety (reported, never silently).
    """

    def __init__(self, dfa: DFA, window: float, max_extend_budget: int = 1_000_000):
        if dfa.containment is None:
            raise ValueError("query must carry RSPQ metadata")
        self.dfa = dfa
        self.window = float(window)
        self.graph = SnapshotGraph()
        self.delta: Dict[object, _STree] = {}
        self.results: Set[Pair] = set()
        self.result_log: List[Tuple[float, Pair]] = []
        self.now: float = NEG_INF
        self.conflicts_detected = 0
        self.extend_calls = 0
        self.max_extend_budget = max_extend_budget
        self._trans_by_label: Dict[int, List[Tuple[int, int]]] = {}
        for s, li, t in dfa.transitions():
            self._trans_by_label.setdefault(li, []).append((s, t))

    def _low(self) -> float:
        return self.now - self.window

    def _emit(self, x: object, v: object) -> None:
        pair = (x, v)
        if pair in self.results:
            return
        self.results.add(pair)
        self.result_log.append((self.now, pair))

    # -- Algorithm Extend ----------------------------------------------------

    def _extend(self, tree: _STree, parent: _SOcc, v: object, t: int,
                edge_ts: float) -> None:
        self.extend_calls += 1
        if self.extend_calls > self.max_extend_budget:
            raise RuntimeError("RSPQ extend budget exhausted (conflict blow-up)")
        nts = min(edge_ts, parent.ts)
        if nts <= self._low():
            return
        path = _path_of(parent)
        # Case 1: t in p[v] -> cycle in the product graph, prune
        states_at_v = [o.state for o in path if o.vertex == v]
        if t in states_at_v:
            return
        # Case 3 (Extend line 2): conflict between FIRST(p[v]) and t at v
        if states_at_v:
            q = states_at_v[0]
            if not bool(self.dfa.containment[q, t]):
                self.conflicts_detected += 1
                self._unmark(tree, parent)
                return
        if v == tree.x:
            # revisiting the root can never yield or extend a simple path
            return
        # Case 2: (v, t) marked -> prune, UNLESS the new path improves the
        # bottleneck timestamp. The paper's RSPQ listing omits the
        # improvement branch, but its own running example (Fig. 2/3,
        # Example 4.2) requires node timestamps to be refreshed by
        # re-insertions exactly as Algorithm Insert does for RAPQ (line 8's
        # "(w,q).ts < min(...)" test); without it, stale timestamps gate
        # valid extensions until the next expiry. We mirror RAPQ here.
        if (v, t) in tree.markings:
            occs = tree.all_occs(v, t)
            best = max(occs, key=lambda o: o.ts) if occs else None
            if best is None or best.ts >= nts:
                return
            # improvement: re-parent; cycle-free because a descendant's ts
            # never strictly exceeds its ancestor's (see RAPQ._insert)
            if best.parent is not None:
                best.parent.children.discard(best)
            best.parent = parent
            parent.children.add(best)
            best.ts = nts
            occ = best
        else:
            # Case 4: extend
            first_occurrence = not tree.all_occs(v, t)
            occ = _SOcc(v, t, nts, parent)
            parent.children.add(occ)
            tree.add(occ)
            if first_occurrence:
                tree.markings.add((v, t))  # Extend lines 7-9
            if t in self.dfa.finals:
                self._emit(tree.x, v)
        # recurse (Extend lines 14-18)
        for w, label, ets in list(self.graph.out_edges(v)):
            if ets <= self._low() or label not in self.dfa.labels:
                continue
            li = self.dfa.labels.index(label)
            r = int(self.dfa.delta[t, li])
            if r < 0:
                continue
            self._extend(tree, occ, w, r, ets)

    # -- Algorithm Unmark ------------------------------------------------------

    def _unmark(self, tree: _STree, last: _SOcc) -> None:
        """Walk the prefix path bottom-up removing markings; re-explore the
        previously pruned extensions of each unmarked node (Unmark lines 7-13).
        """
        Q: List[Tuple[object, int]] = []
        cur: Optional[_SOcc] = last
        while cur is not None and (cur.vertex, cur.state) in tree.markings:
            key = (cur.vertex, cur.state)
            tree.markings.discard(key)
            Q.append(key)
            cur = cur.parent
        for (v, t) in Q:
            # paths previously pruned because (v, t) was marked: any valid
            # in-edge (w, v) with delta(q, label) = t and (w, q) in T_x
            for w, label, ets in list(self.graph.in_edges(v)):
                if ets <= self._low() or label not in self.dfa.labels:
                    continue
                li = self.dfa.labels.index(label)
                for (q, tt) in self._trans_by_label.get(li, ()):  # (w,q)->(v,t)
                    if tt != t:
                        continue
                    parents = list(tree.all_occs(w, q))
                    if (w, q) == (tree.x, self.dfa.start):
                        parents = [tree.root]
                    for pocc in parents:
                        if pocc.ts <= self._low():
                            continue
                        self._extend(tree, pocc, v, t, ets)

    # -- Algorithm RSPQ (per arriving + tuple) ---------------------------------

    def insert(self, u: object, v: object, label: str, ts: float) -> Set[Pair]:
        self.now = max(self.now, ts)
        before = len(self.result_log)
        if label not in self.dfa.labels:
            return set()
        self.graph.upsert(u, v, label, ts)
        li = self.dfa.labels.index(label)
        low = self._low()
        for (s, t) in self._trans_by_label.get(li, ()):  # lines 5-12
            if s == self.dfa.start:
                tree = self.delta.get(u)
                if tree is None:
                    tree = _STree(u, self.dfa.start)
                    self.delta[u] = tree
                self._extend(tree, tree.root, v, t, ts)
            for x, tree in list(self.delta.items()):
                for parent in list(tree.all_occs(u, s)):
                    if parent.ts <= low or parent is tree.root:
                        continue
                    self._extend(tree, parent, v, t, ts)
        return {p for (_ts, p) in self.result_log[before:]}

    # -- Algorithm ExpiryRSPQ ---------------------------------------------------

    def expire(self, tau: Optional[float] = None) -> Set[Pair]:
        if tau is not None:
            self.now = max(self.now, tau)
        low = self._low()
        self.graph.prune(low)
        invalidated: Set[Pair] = set()
        for x, tree in list(self.delta.items()):
            invalidated |= self._expire_tree(tree, low)
            if tree.n_nodes() <= 1:
                del self.delta[x]
        return invalidated

    def _expire_tree(self, tree: _STree, low: float) -> Set[Pair]:
        # E: expired occurrences (line 2)
        expired = [occ for lst in tree.occs.values() for occ in lst
                   if occ.ts <= low and occ is not tree.root]
        if not expired:
            return set()
        P = {(o.vertex, o.state) for o in expired} & tree.markings  # line 3
        for occ in expired:  # lines 4-5
            tree.remove(occ)
            if occ.parent is not None:
                occ.parent.children.discard(occ)
            occ.parent = None
        for key in list(P):
            if not tree.all_occs(*key):
                tree.markings.discard(key)
        # lines 6-11: reconnect marked expired pairs from valid parents
        for (v, t) in list(P):
            for u, label, ets in list(self.graph.in_edges(v)):
                if ets <= low or label not in self.dfa.labels:
                    continue
                li = self.dfa.labels.index(label)
                for (s, tt) in self._trans_by_label.get(li, ()):
                    if tt != t:
                        continue
                    parents = list(tree.all_occs(u, s))
                    if (u, s) == (tree.x, self.dfa.start):
                        parents = [tree.root]
                    for pocc in parents:
                        if pocc.ts <= low:
                            continue
                        self._extend(tree, pocc, v, t, ets)
        # lines 12-19: invalidations (the marking-restoration step of the
        # paper's listing is under-specified; we conservatively leave parents
        # unmarked — correctness of result sets is oracle-validated)
        invalidated: Set[Pair] = set()
        for (v, t) in P:
            if t in self.dfa.finals and not tree.all_occs(v, t):
                if not any(tree.all_occs(v, tf) for tf in self.dfa.finals):
                    invalidated.add((tree.x, v))
        return invalidated

    def current_results(self) -> Set[Pair]:
        low = self._low()
        out: Set[Pair] = set()
        for x, tree in self.delta.items():
            for (v, t), lst in tree.occs.items():
                if t in self.dfa.finals and any(
                    o.ts > low and o is not tree.root for o in lst
                ):
                    out.add((x, v))
        return out

    def index_size(self) -> Tuple[int, int]:
        return len(self.delta), sum(t.n_nodes() for t in self.delta.values())
