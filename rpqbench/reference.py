"""The plain reference that decides ``correct``: what the persistent-query
service must answer, worked out on the host from the generated stream and
the query strings alone.

Semantics (the paper's implicit-window model with eager evaluation and
lazy expiration, as the service states it):

* The graph holds, per (u, v, label), the newest timestamp inserted since
  the edge was last deleted; at each slide boundary edges at or below
  ``now - window`` leave it. Timestamps and the clock are float32, as the
  service keeps them, and a path is valid while its oldest edge is
  strictly newer than ``now - window``.
* A query answers a pair (x, y) when some path of one or more edges from
  x to y, all valid, spells a word of its language. Each insert reports
  the pairs valid after it that the query never reported before (the
  result stream is append-only). An explicit delete reports the pairs
  valid before it and not after it, at the delete's clock. A query
  registered late answers at once the pairs valid over the retained
  graph; a retired query answers nothing.
* A simple-path lane drops the pairs (x, x). Its automaton may allow a
  conflict (Definition 16 of the paper, over-approximated: some source
  reaches one vertex in two states whose suffix languages are not
  contained one in the other); at the first insert or registration after
  which a conflict is possible, the service hands the lane to an exact
  simple-path engine, and it answers from that after the event. The
  reference then works the lane out afresh (:class:`SimpleLane`): after
  each event, the pairs (x, y) joined by a path of valid edges that visits
  no vertex twice and spells a word of the language, found by a
  depth-first search from every source. Each insert reports those never
  reported before, each explicit delete those valid before it and not
  after it.

The state is a bottleneck closure kept per automaton: for each source x,
``best[x][(v, s)]`` is the largest oldest-edge timestamp over valid paths
from (x, start) to (v, s). An insert raises entries by a widest-path
search from the new edge; a delete recomputes only the sources whose best
paths can use the edge. Nothing here imports the program.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .automaton import Dfa, compile_query

NEG_INF = float("-inf")
Pair = Tuple[object, object]
FALLBACK_REASON = "conflict -> reference RSPQ"


def to_float32(x: float) -> float:
    return float(np.float32(x))


class Closure:
    """The bottleneck closure of one automaton over the shared graph."""

    def __init__(self, dfa: Dfa, graph: "Graph"):
        self.dfa = dfa
        self.graph = graph
        self.best: Dict[object, Dict[Tuple[object, int], float]] = {}
        self.occ: Dict[Tuple[object, int], Set[object]] = {}
        self.by_label: Dict[str, List[Tuple[int, int]]] = {}
        for s, li, t in dfa.transitions():
            self.by_label.setdefault(dfa.labels[li], []).append((s, t))
        self.starts = {lab for lab, st in self.by_label.items()
                       if any(s == dfa.start for s, _t in st)}

    def _set(self, x, node, val: float, changed: Optional[Set], heap: List) -> None:
        row = self.best.setdefault(x, {})
        row[node] = val
        self.occ.setdefault(node, set()).add(x)
        if changed is not None:
            changed.add((x, node))
        heapq.heappush(heap, (-val, x, node))

    def _expand(self, heap: List, low: float, changed: Optional[Set]) -> None:
        """Widest-path search: pop the largest entry, relax its out-edges."""
        while heap:
            negv, x, node = heapq.heappop(heap)
            val = -negv
            row = self.best[x]
            if row.get(node) != val:
                continue
            v, s = node
            for (w, lab), ts in self.graph.out.get(v, {}).items():
                for (s2, t2) in self.by_label.get(lab, ()):
                    if s2 != s:
                        continue
                    cand = min(val, ts)
                    if cand > low and cand > row.get((w, t2), NEG_INF):
                        self._set(x, (w, t2), cand, changed, heap)

    def insert(self, u, v, lab: str, ts: float, low: float) -> Set:
        """Raise the entries the new edge improves; returns the changed
        (x, (v, s)) entries."""
        changed: Set = set()
        if ts <= low:
            return changed
        heap: List = []
        for (s, t) in self.by_label.get(lab, ()):
            tails = []
            if s == self.dfa.start:
                tails.append((u, float("inf")))
            for x in list(self.occ.get((u, s), ())):
                val = self.best[x].get((u, s), NEG_INF)
                if val > low:
                    tails.append((x, val))
            for x, val in tails:
                cand = min(val, ts)
                if cand > low and cand > self.best.get(x, {}).get((v, t), NEG_INF):
                    self._set(x, (v, t), cand, changed, heap)
        self._expand(heap, low, changed)
        return changed

    def affected(self, u, v, lab: str, ts: float, low: float) -> Set:
        """Sources whose best entries some best path through the edge
        attains (the others keep every entry when the edge goes)."""
        rows = set()
        if ts <= low:
            return rows
        for (s, t) in self.by_label.get(lab, ()):
            tails = []
            if s == self.dfa.start:
                tails.append((u, float("inf")))
            for x in self.occ.get((u, s), ()):
                tails.append((x, self.best[x].get((u, s), NEG_INF)))
            for x, val in tails:
                cand = min(val, ts)
                if cand > low and cand >= self.best.get(x, {}).get((v, t), NEG_INF):
                    rows.add(x)
        return rows

    def drop_row(self, x) -> None:
        for node in self.best.pop(x, {}):
            xs = self.occ.get(node)
            if xs is not None:
                xs.discard(x)
                if not xs:
                    del self.occ[node]

    def build_row(self, x, low: float) -> None:
        """The source's entries from scratch over the valid edges."""
        self.drop_row(x)
        heap: List = []
        for (w, lab), ts in self.graph.out.get(x, {}).items():
            if lab not in self.starts:
                continue
            for (s, t) in self.by_label[lab]:
                if s == self.dfa.start and ts > low \
                        and ts > self.best.get(x, {}).get((w, t), NEG_INF):
                    self._set(x, (w, t), ts, None, heap)
        self._expand(heap, low, None)

    def build(self, low: float) -> None:
        for x in list(self.best):
            self.drop_row(x)
        for x in list(self.graph.out):
            self.build_row(x, low)

    def prune(self, low: float) -> None:
        """Forget entries that can never be valid again (the clock only
        grows)."""
        for x in list(self.best):
            row = self.best[x]
            dead = [node for node, val in row.items() if val <= low]
            for node in dead:
                del row[node]
                xs = self.occ[node]
                xs.discard(x)
                if not xs:
                    del self.occ[node]
            if not row:
                del self.best[x]

    def valid_targets(self, x, low: float) -> Set:
        return {v for (v, s), val in self.best.get(x, {}).items()
                if s in self.dfa.finals and val > low}

    def valid_pairs(self, low: float) -> Set[Pair]:
        return {(x, v) for x in self.best for v in self.valid_targets(x, low)}

    def conflict(self, low: float, entries: Optional[Iterable] = None) -> bool:
        """Definition 16 over-approximated: some source reaches a vertex in
        states s, t with [s] not containing [t] (over the given changed
        entries, or all of them)."""
        nc = ~self.dfa.containment
        if entries is None:
            entries = [(x, node) for x, row in self.best.items() for node in row]
        for x, (v, s) in entries:
            row = self.best.get(x, {})
            if row.get((v, s), NEG_INF) <= low:
                continue
            for t in range(self.dfa.k):
                if (nc[s, t] or nc[t, s]) and row.get((v, t), NEG_INF) > low:
                    return True
        return False


class Graph:
    """The retained graph: newest timestamp per (u, v, label)."""

    def __init__(self):
        self.edges: Dict[Tuple[object, object, str], float] = {}
        self.out: Dict[object, Dict[Tuple[object, str], float]] = {}

    def upsert(self, u, v, lab: str, ts: float) -> None:
        key = (u, v, lab)
        ts = max(ts, self.edges.get(key, NEG_INF))
        self.edges[key] = ts
        self.out.setdefault(u, {})[(v, lab)] = ts

    def remove(self, u, v, lab: str) -> Optional[float]:
        ts = self.edges.pop((u, v, lab), None)
        if ts is not None:
            row = self.out[u]
            del row[(v, lab)]
            if not row:
                del self.out[u]
        return ts

    def expire(self, low: float) -> None:
        for (u, v, lab) in [k for k, ts in self.edges.items() if ts <= low]:
            self.remove(u, v, lab)

    def retained(self) -> List[Tuple[object, object, str, float]]:
        return sorted(((u, v, lab, ts) for (u, v, lab), ts in self.edges.items()),
                      key=lambda e: e[3])


class SimpleLane:
    """A simple-path lane after its hand-over. The service's exact engine
    keeps its own copy of the window: the edges retained at the hand-over,
    with their float32 timestamps, then each later sgt with its own
    (float64) timestamp, under the service's float64 clock. A path is
    valid while each of its edges is newer than ``now - window``."""

    def __init__(self, dfa: Dfa, window: float, reported: Set[Pair],
                 edges: Iterable[Tuple[object, object, str, float]], now: float):
        self.dfa = dfa
        self.window = float(window)
        self.reported: Set[Pair] = set(reported)
        self.index = {lab: i for i, lab in enumerate(dfa.labels)}
        #: u -> {(v, label index): newest timestamp}
        self.out: Dict[object, Dict[Tuple[object, int], float]] = {}
        self.now = now
        for u, v, lab, ts in edges:
            self._upsert(u, v, lab, ts)
        # the automaton's states from which a final state can be reached
        live = set(dfa.finals)
        grew = True
        while grew:
            grew = False
            for s, _li, t in dfa.transitions():
                if t in live and s not in live:
                    live.add(s)
                    grew = True
        self.live = live

    def _upsert(self, u, v, lab: str, ts: float) -> None:
        self.now = max(self.now, ts)
        li = self.index.get(lab)
        if li is not None:
            row = self.out.setdefault(u, {})
            row[(v, li)] = max(ts, row.get((v, li), NEG_INF))

    def pairs(self) -> Set[Pair]:
        """Every (x, y), x != y, joined by a simple path of valid edges
        that spells a word of the language."""
        low = self.now - self.window
        delta, finals, live, out = self.dfa.delta, self.dfa.finals, self.live, self.out
        found: Set[Pair] = set()
        for x in out:
            on_path = {x}
            stack = [(x, iter(out[x].items()), self.dfa.start)]
            while stack:
                v, edges, s = stack[-1]
                for (w, li), ts in edges:
                    if ts <= low or w in on_path:
                        continue
                    t = int(delta[s, li])
                    if t < 0 or t not in live:
                        continue
                    if t in finals:
                        found.add((x, w))
                    on_path.add(w)
                    stack.append((w, iter(out.get(w, {}).items()), t))
                    break
                else:
                    stack.pop()
                    on_path.discard(v)
        return found

    def insert(self, u, v, lab: str, ts: float) -> Set[Pair]:
        self._upsert(u, v, lab, ts)
        if lab not in self.index:
            return set()
        fresh = self.pairs() - self.reported
        self.reported |= fresh
        return fresh

    def delete(self, u, v, lab: str, ts: float) -> Set[Pair]:
        self.now = max(self.now, ts)
        row = self.out.get(u, {})
        key = (v, self.index.get(lab))
        if key not in row:
            return set()
        before = self.pairs()
        del row[key]
        return before - self.pairs()

    def expire(self, ts: float) -> None:
        """Forget the edges that can never be valid again."""
        self.now = max(self.now, ts)
        low = self.now - self.window
        for u in list(self.out):
            row = {k: t for k, t in self.out[u].items() if t > low}
            if row:
                self.out[u] = row
            else:
                del self.out[u]


class Lane:
    def __init__(self, name: str, dfa: Dfa, simple: bool):
        self.name = name
        self.dfa = dfa
        self.simple = simple
        self.check_conflict = simple and not dfa.has_containment_property
        self.reported: Set[Pair] = set()
        self.flagged = False


class ServiceReference:
    """The service's answers, event by event (see the module docstring)."""

    def __init__(self, window: float, slide: float):
        self.q = to_float32
        self.window = float(window)
        self.slide = float(slide)
        self.graph = Graph()
        self.closures: Dict[Tuple, Closure] = {}
        self.lanes: Dict[str, Lane] = {}
        self.fallbacks: Dict[str, SimpleLane] = {}
        self.now = NEG_INF          # the clock, float32
        self.host_now = NEG_INF     # the service's float64 clock
        self.next_expiry = float(slide)
        self.started = False
        #: the labels of every query registered so far: the service drops
        #: the edges of other labels, and keeps its alphabet when a query goes
        self.alphabet: Set[str] = set()

    # -- helpers -------------------------------------------------------------

    def _low(self) -> float:
        return self.q(self.now - self.q(self.window))

    def _closure(self, dfa: Dfa) -> Closure:
        c = self.closures.get(dfa.key())
        if c is None:
            c = Closure(dfa, self.graph)
            if self.started:
                c.build(self._low())
            self.closures[dfa.key()] = c
        return c

    def _lanes_of(self, c: Closure) -> List[Lane]:
        return [ln for ln in self.lanes.values() if ln.dfa.key() == c.dfa.key()]

    def _advance(self, ts: float) -> None:
        self.now = max(self.now, self.q(ts))
        self.host_now = max(self.host_now, ts)

    def _hand_over(self, fallbacks: Dict[str, str]) -> None:
        for name, lane in list(self.lanes.items()):
            if not lane.flagged:
                continue
            self.fallbacks[name] = SimpleLane(lane.dfa, self.window, lane.reported,
                                              self.graph.retained(), self.host_now)
            fallbacks[name] = FALLBACK_REASON
            self._drop_lane(name)

    def _drop_lane(self, name: str) -> None:
        lane = self.lanes.pop(name)
        key = lane.dfa.key()
        if not any(ln.dfa.key() == key for ln in self.lanes.values()):
            del self.closures[key]

    # -- the service's calls -------------------------------------------------

    def register(self, name: str, expr: str, simple: bool = False) -> Set[Pair]:
        """A dense registration; returns the initial answers."""
        dfa = compile_query(expr)
        self.alphabet |= set(dfa.labels)
        lane = Lane(name, dfa, simple)
        self.lanes[name] = lane
        c = self._closure(dfa)
        if not self.started:
            return set()
        low = self._low()
        initial = {p for p in c.valid_pairs(low) if not (simple and p[0] == p[1])}
        lane.reported = set(initial)
        if lane.check_conflict and c.conflict(low):
            lane.flagged = True
        return initial

    def deregister(self, name: str) -> None:
        if name in self.lanes:
            self._drop_lane(name)
        else:
            del self.fallbacks[name]

    def event(self, ts: float, u, v, lab: str, op: str):
        """One sgt through ``ingest``: (new pairs, invalidated pairs,
        fallbacks), each a dict by query name."""
        self.started = True
        new: Dict[str, Set[Pair]] = {}
        inv: Dict[str, Set[Pair]] = {}
        fallbacks: Dict[str, str] = {}
        if ts >= self.next_expiry:
            self._advance(ts)
            self.graph.expire(self._low())
            for c in self.closures.values():
                c.prune(self._low())
            for fb in self.fallbacks.values():
                fb.expire(ts)
            while self.next_expiry <= ts:
                self.next_expiry += self.slide
        refs = list(self.fallbacks.items())
        self._advance(ts)
        low = self._low()
        if lab not in self.alphabet:
            pass
        elif op == "+":
            self.graph.upsert(u, v, lab, self.q(ts))
            edge_ts = self.graph.edges[(u, v, lab)]
            for c in list(self.closures.values()):
                changed = c.insert(u, v, lab, edge_ts, low)
                finals = {(x, w) for x, (w, s) in changed if s in c.dfa.finals}
                for lane in self._lanes_of(c):
                    fresh = {p for p in finals
                             if not (lane.simple and p[0] == p[1])} - lane.reported
                    if fresh:
                        lane.reported |= fresh
                        new[lane.name] = fresh
                    if lane.check_conflict and not lane.flagged \
                            and c.conflict(low, changed):
                        lane.flagged = True
        elif (u, v, lab) in self.graph.edges:
            edge_ts = self.graph.edges[(u, v, lab)]
            plans = []
            for c in self.closures.values():
                rows = c.affected(u, v, lab, edge_ts, low)
                plans.append((c, {x: c.valid_targets(x, low) for x in rows}))
            self.graph.remove(u, v, lab)
            for c, before in plans:
                lost: Set[Pair] = set()
                for x, targets in before.items():
                    c.build_row(x, low)
                    lost |= {(x, w) for w in targets - c.valid_targets(x, low)}
                for lane in self._lanes_of(c):
                    gone = {p for p in lost if not (lane.simple and p[0] == p[1])}
                    if gone:
                        inv[lane.name] = gone
        self._hand_over(fallbacks)
        for name, fb in refs:
            if op == "+":
                res = fb.insert(u, v, lab, ts)
                if res:
                    new[name] = set(res)
            else:
                res = fb.delete(u, v, lab, ts)
                if res:
                    inv[name] = set(res)
        return new, inv, fallbacks
