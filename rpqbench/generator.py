"""The benchmark's own stream generator: the SO-like stream of the paper's
experiments (preferential attachment on both endpoints over one vertex
type, the three sx-stackoverflow labels) and its deletion protocol.

A frozen copy of ``repro_torch.streaming.generators.so_like`` and
``with_deletions``: the same ``random.Random`` calls in the same order, so
the same seed gives the same sgts. The one change is the weighted draw:
the original scans all n degrees on every draw (~16k Python steps an edge
at 8192 vertices); here a Fenwick tree over the degrees finds the same
index in O(log n) from the same ``rng.random()`` value.
"""
from __future__ import annotations

import random
from typing import List, NamedTuple

SO_LABELS = ("a2q", "c2a", "c2q")


class Sgt(NamedTuple):
    """One streaming graph tuple: timestamp, edge, label, op ('+' | '-')."""

    ts: float
    src: int
    dst: int
    label: str
    op: str = "+"


class Fenwick:
    """Prefix sums over integer weights, and the first index whose
    inclusive prefix sum reaches a value."""

    def __init__(self, weights: List[int]):
        n = len(weights)
        self.n = n
        self.tree = [0] * (n + 1)
        for i, w in enumerate(weights, start=1):
            self.tree[i] += w
            j = i + (i & -i)
            if j <= n:
                self.tree[j] += self.tree[i]
        self.total = sum(weights)
        self._top = 1 << (n.bit_length() - 1) if n else 0

    def add(self, i: int, delta: int) -> None:
        self.total += delta
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & -i

    def first_reaching(self, r: float) -> int:
        """The smallest i with weights[0] + ... + weights[i] >= r (the last
        index when no prefix reaches r)."""
        pos, acc, step = 0, 0, self._top
        while step:
            nxt = pos + step
            # the original's test is ``r <= acc`` on the integer prefix sum
            if nxt <= self.n and acc + self.tree[nxt] < r:
                pos = nxt
                acc += self.tree[nxt]
            step >>= 1
        return min(pos, self.n - 1)


def so_like(n_vertices: int, n_edges: int, seed: int, rate: float) -> List[Sgt]:
    """StackOverflow-style inserts: exponential gaps at ``rate`` per stream
    second, both endpoints by preferential attachment, a uniform label."""
    rng = random.Random(seed)
    degree = Fenwick([1] * n_vertices)
    out: List[Sgt] = []
    t = 0.0
    for _ in range(n_edges):
        t += rng.expovariate(rate)
        u = degree.first_reaching(rng.random() * degree.total)
        v = degree.first_reaching(rng.random() * degree.total)
        degree.add(u, 1)
        degree.add(v, 1)
        out.append(Sgt(t, u, v, rng.choice(SO_LABELS)))
    return out


def with_deletions(stream: List[Sgt], ratio: float, seed: int) -> List[Sgt]:
    """After each insert, with probability ``ratio``, re-emit a uniformly
    chosen earlier insert as a negative tuple 1 ms later (the port's
    deletion protocol), in timestamp order."""
    rng = random.Random(seed)
    out: List[Sgt] = []
    inserted: List[Sgt] = []
    t_last = 0.0
    for sgt in stream:
        out.append(sgt)
        inserted.append(sgt)
        t_last = sgt.ts
        if inserted and rng.random() < ratio:
            victim = inserted.pop(rng.randrange(len(inserted)))
            t_last += 1e-3
            out.append(Sgt(t_last, victim.src, victim.dst, victim.label, "-"))
    out.sort(key=lambda s: s.ts)
    return out
