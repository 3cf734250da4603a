"""Batch (non-incremental) RPQ evaluation baselines.

Two roles:

* the *oracle* for property tests (product-graph BFS for arbitrary
  semantics; exhaustive simple-path DFS for simple-path semantics), and
* the §5.6 comparison point: the paper emulates persistent evaluation on
  Virtuoso by re-running the batch algorithm on the window content after
  every update; ``benchmarks/fig11_vs_batch.py`` does the same against the
  incremental engines.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, List, Set, Tuple

from .automaton import DFA
from .reference import SnapshotGraph

Pair = Tuple[object, object]
Edge = Tuple[object, object, str, float]  # (u, v, label, ts)


def snapshot_from_edges(edges: Iterable[Edge], low: float = float("-inf"),
                        high: float = float("inf")) -> SnapshotGraph:
    """Window content: edges with ts in (low, high]."""
    g = SnapshotGraph()
    for (u, v, label, ts) in edges:
        if low < ts <= high:
            g.upsert(u, v, label, ts)
    return g


def batch_rapq(graph: SnapshotGraph, dfa: DFA) -> Set[Pair]:
    """Batch RPQ under arbitrary path semantics: BFS of the product graph
    from every (x, s0) (paper §3, 'Batch Algorithm'). O(n·m·k^2)."""
    results: Set[Pair] = set()
    vertices = graph.vertices()
    for x in vertices:
        seen: Set[Tuple[object, int]] = {(x, dfa.start)}
        queue: deque = deque([(x, dfa.start)])
        while queue:
            u, s = queue.popleft()
            for v, label, _ts in graph.out_edges(u):
                t = dfa.step(s, label)
                if t < 0:
                    continue
                # report on every traversal (length >= 1) so genuine cycles
                # back to (x, s0) with s0 final yield (x, x); empty paths
                # are never reported (matches the streaming algorithms)
                if t in dfa.finals:
                    results.add((x, v))
                if (v, t) in seen:
                    continue
                seen.add((v, t))
                queue.append((v, t))
    return results


def batch_rspq_bruteforce(graph: SnapshotGraph, dfa: DFA,
                          max_nodes: int = 200_000) -> Set[Pair]:
    """Exhaustive simple-path enumeration over the product graph (exponential;
    small graphs only). The ground truth for simple-path semantics."""
    results: Set[Pair] = set()
    budget = [max_nodes]

    def dfs(x: object, u: object, s: int, visited: Set[object]) -> None:
        budget[0] -= 1
        if budget[0] < 0:
            raise RuntimeError("bruteforce budget exhausted")
        for v, label, _ts in graph.out_edges(u):
            if v in visited:
                continue
            t = dfa.step(s, label)
            if t < 0:
                continue
            if t in dfa.finals:
                results.add((x, v))
            visited.add(v)
            dfs(x, v, t, visited)
            visited.discard(v)

    for x in graph.vertices():
        dfs(x, x, dfa.start, {x})
    return results


def streaming_oracle(edges: List[Edge], dfa: DFA, window: float,
                     simple: bool = False) -> Set[Pair]:
    """Implicit-window streaming result set via repeated batch evaluation:
    Q(S, W, tau) = union over arrival times of the snapshot results
    (Definition 9). Quadratic in stream length — test oracle only."""
    out: Set[Pair] = set()
    for i, (_u, _v, _label, ts) in enumerate(edges):
        snap = snapshot_from_edges(edges[: i + 1], low=ts - window, high=ts)
        if simple:
            out |= batch_rspq_bruteforce(snap, dfa)
        else:
            out |= batch_rapq(snap, dfa)
    return out
