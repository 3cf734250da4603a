"""Synthetic streaming-graph generators mirroring the paper's workloads
(§5.1.2): SO-like (homogeneous, highly cyclic, 3 labels), LDBC-like
(social-network interactions, skewed), Yago-like (rich schema, ~100 labels,
sparse), and gMark-like (schema-driven with tunable recursion).

All are deterministic in the seed, emit strictly increasing timestamps, and
scale by (n_vertices, n_edges)."""
from __future__ import annotations

import collections
import random
from typing import List, Sequence, Tuple

from .stream import SGT, Stream

SO_LABELS = ["a2q", "c2a", "c2q"]
LDBC_LABELS = ["knows", "replyOf", "hasCreator", "likes", "hasTag", "isLocatedIn",
               "studyAt", "workAt"]


def so_like(n_vertices: int, n_edges: int, seed: int = 0,
            rate: float = 10.0) -> Stream:
    """StackOverflow-style: one vertex type, 3 interaction labels, heavy
    preferential attachment -> dense cyclic core."""
    rng = random.Random(seed)
    degree = [1] * n_vertices
    tuples = []
    t = 0.0
    for _ in range(n_edges):
        t += rng.expovariate(rate)
        # preferential attachment on both endpoints
        u = _weighted(rng, degree)
        v = _weighted(rng, degree)
        degree[u] += 1
        degree[v] += 1
        tuples.append(SGT(t, u, v, rng.choice(SO_LABELS)))
    return Stream(tuples)


def ldbc_like(n_persons: int, n_edges: int, seed: int = 0,
              rate: float = 10.0) -> Stream:
    """LDBC SNB-style update stream: persons + posts, 8 interaction types,
    recursive relations (knows, replyOf) between same-kind vertices."""
    rng = random.Random(seed)
    n_posts = 3 * n_persons
    tuples = []
    t = 0.0
    for _ in range(n_edges):
        t += rng.expovariate(rate)
        lab = rng.choice(LDBC_LABELS)
        if lab == "knows":
            u = ("p", rng.randrange(n_persons))
            v = ("p", rng.randrange(n_persons))
        elif lab == "replyOf":
            u = ("m", rng.randrange(n_posts))
            v = ("m", rng.randrange(n_posts))
        elif lab in ("hasCreator", "likes"):
            u = ("m", rng.randrange(n_posts))
            v = ("p", rng.randrange(n_persons))
            if lab == "likes":
                u, v = v, u
        else:
            u = ("p", rng.randrange(n_persons))
            v = ("org", rng.randrange(max(n_persons // 10, 1)))
        tuples.append(SGT(t, u, v, lab))
    return Stream(tuples)


def yago_like(n_vertices: int, n_edges: int, n_labels: int = 100,
              seed: int = 0, rate: float = 10.0) -> Stream:
    """RDF-ish: many labels with Zipf label frequency, sparse structure.
    Timestamps assigned at a fixed rate (paper's Yago2s windowing setup)."""
    rng = random.Random(seed)
    labels = [f"p{i}" for i in range(n_labels)]
    weights = [1.0 / (i + 1) for i in range(n_labels)]
    tuples = []
    t = 0.0
    for _ in range(n_edges):
        t += 1.0 / rate  # fixed rate: equal #edges per window
        u = rng.randrange(n_vertices)
        v = rng.randrange(n_vertices)
        tuples.append(SGT(t, u, v, rng.choices(labels, weights)[0]))
    return Stream(tuples)


def gmark_like(n_vertices: int, n_edges: int, labels: Sequence[str],
               seed: int = 0, rate: float = 10.0,
               cyclicity: float = 0.3) -> Stream:
    """Schema-driven generator with a tunable fraction of cycle-closing
    edges (the knob that stresses Kleene-star queries)."""
    rng = random.Random(seed)
    tuples = []
    t = 0.0
    # deque: the sliding 64-vertex recency window drops its oldest entry
    # in O(1) (rng.choice indexes it, so draws are identical to a list)
    recent: collections.deque = collections.deque()
    for _ in range(n_edges):
        t += rng.expovariate(rate)
        if recent and rng.random() < cyclicity:
            u = rng.choice(recent)
            v = rng.choice(recent)
        else:
            u = rng.randrange(n_vertices)
            v = rng.randrange(n_vertices)
        recent.append(v)
        if len(recent) > 64:
            recent.popleft()
        tuples.append(SGT(t, u, v, rng.choice(list(labels))))
    return Stream(tuples)


def with_deletions(stream: Stream, ratio: float, seed: int = 0) -> Stream:
    """Re-emit a fraction of previously inserted edges as negative tuples
    (the paper's §5.4 protocol)."""
    rng = random.Random(seed)
    tuples: List[SGT] = []
    inserted: List[SGT] = []
    t_last = 0.0
    for sgt in stream:
        tuples.append(sgt)
        inserted.append(sgt)
        t_last = sgt.ts
        if inserted and rng.random() < ratio:
            victim = inserted.pop(rng.randrange(len(inserted)))
            t_last += 1e-3
            tuples.append(SGT(t_last, victim.src, victim.dst, victim.label, "-"))
    return Stream(tuples)


# -- adversarial workloads ----------------------------------------------------
#
# The generators above model the paper's steady-state benchmarks. The ones
# below model the traffic that breaks services in production: bursty
# arrival processes, hotspot skew, deletion storms, query churn, and window
# scales spanning 100x. They are the input side of the supervision layer
# (streaming/supervisor.py) — deterministic in the seed like everything
# else here, so chaos results are reproducible.


def bursty_arrivals(n_vertices: int, n_edges: int, seed: int = 0,
                    base_rate: float = 10.0, diurnal_amp: float = 0.8,
                    period: float = 50.0, flash_every: int = 0,
                    flash_len: int = 32, flash_boost: float = 50.0,
                    labels: Sequence[str] = tuple(SO_LABELS)) -> Stream:
    """Diurnal arrivals plus flash crowds: the instantaneous rate follows a
    sinusoid (peak/trough ratio set by ``diurnal_amp``), and every
    ``flash_every`` edges a flash crowd multiplies the rate by
    ``flash_boost`` for ``flash_len`` edges while concentrating endpoints
    on a small hot set — inter-arrival gaps collapse, so micro-batches go
    from sparse to saturated within one window."""
    import math

    rng = random.Random(seed)
    tuples = []
    t = 0.0
    hot = [rng.randrange(n_vertices) for _ in range(max(4, n_vertices // 50))]
    flash_left = 0
    for i in range(n_edges):
        if flash_every and flash_left == 0 and i > 0 and i % flash_every == 0:
            flash_left = flash_len
        rate = base_rate * (1.0 + diurnal_amp * math.sin(
            2.0 * math.pi * (t / period)))
        rate = max(rate, 0.1 * base_rate)
        if flash_left > 0:
            rate *= flash_boost
            flash_left -= 1
            u = rng.choice(hot)
            v = rng.choice(hot) if rng.random() < 0.5 \
                else rng.randrange(n_vertices)
        else:
            u = rng.randrange(n_vertices)
            v = rng.randrange(n_vertices)
        t += rng.expovariate(rate)
        tuples.append(SGT(t, u, v, rng.choice(list(labels))))
    return Stream(tuples)


def powerlaw_hotspot(n_vertices: int, n_edges: int, seed: int = 0,
                     rate: float = 10.0, alpha: float = 1.2,
                     labels: Sequence[str] = tuple(SO_LABELS)) -> Stream:
    """Zipf(``alpha``) endpoint skew: a handful of celebrity vertices absorb
    most edges, driving per-row fanout far past any uniform model — the
    stress case for ELL row caps and row-sparse dist overflow."""
    rng = random.Random(seed)
    weights = [1.0 / ((i + 1) ** alpha) for i in range(n_vertices)]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w
        cum.append(acc / total)
    import bisect

    def draw() -> int:
        return bisect.bisect_left(cum, rng.random())

    tuples = []
    t = 0.0
    for _ in range(n_edges):
        t += rng.expovariate(rate)
        tuples.append(SGT(t, draw(), draw(), rng.choice(list(labels))))
    return Stream(tuples)


def deletion_storm(stream: Stream, storm_ratio: float = 0.5,
                   storm_every: int = 64, storm_len: int = 24,
                   seed: int = 0) -> Stream:
    """Deletion-heavy stream: quiet stretches at a trickle deletion rate,
    then storms where up to ``storm_ratio`` of the live edge set is
    re-emitted negative in timestamp order — the shape that floods the
    cone-seeded re-derivation path and the dist overflow ring."""
    rng = random.Random(seed)
    tuples: List[SGT] = []
    live: List[SGT] = []
    t_last = 0.0
    since_storm = 0
    for sgt in stream:
        tuples.append(sgt)
        live.append(sgt)
        t_last = sgt.ts
        since_storm += 1
        if since_storm >= storm_every and live:
            since_storm = 0
            n_kill = min(len(live),
                         max(1, int(min(storm_len,
                                        storm_ratio * len(live)))))
            for _ in range(n_kill):
                victim = live.pop(rng.randrange(len(live)))
                t_last += 1e-3
                tuples.append(
                    SGT(t_last, victim.src, victim.dst, victim.label, "-"))
    return Stream(tuples)


def mixed_window_streams(n_vertices: int, n_edges: int, seed: int = 0,
                         rate: float = 10.0) -> List[dict]:
    """Window sizes spanning 100x over the same arrival process: each entry
    pairs a stream with (window, slide) so a harness can sweep expiry
    pressure from "almost nothing expires" to "the window churns every
    few batches". Returns ``[{stream, window, slide, name}, ...]``."""
    out = []
    base = so_like(n_vertices, n_edges, seed=seed, rate=rate)
    for i, window in enumerate((2.0, 20.0, 200.0)):
        out.append({
            "name": f"w{window:g}",
            "stream": Stream(list(base)),
            "window": window,
            "slide": max(window / 10.0, 0.2),
            "seed": seed + i,
        })
    return out


def churn_storm_plan(n_batches: int, seed: int = 0,
                     churn_every: int = 8,
                     exprs: Sequence[Tuple[str, str]] = ()) -> List[Tuple]:
    """A deterministic query-churn schedule: every ``churn_every`` batches
    emit a (batch_idx, op, name, expr) op that registers a fresh query or
    deregisters a previously added one — the storm alternates so the live
    query set keeps shifting. ``exprs`` is the pool of (kind, expr) pairs
    to draw from (kind = "rpq" | "rapq")."""
    rng = random.Random(seed)
    pool = list(exprs) or [("rpq", "a2q+"), ("rpq", "c2a . a2q"),
                           ("rpq", "(c2q | c2a) . a2q*")]
    plan: List[Tuple] = []
    live: List[str] = []
    n = 0
    for b in range(churn_every, n_batches, churn_every):
        if live and rng.random() < 0.4:
            name = live.pop(rng.randrange(len(live)))
            plan.append((b, "deregister", name, None, None))
        else:
            kind, expr = pool[rng.randrange(len(pool))]
            name = f"storm_{n}"
            n += 1
            live.append(name)
            plan.append((b, "register", name, kind, expr))
    return plan


def _weighted(rng: random.Random, weights: List[int]) -> int:
    total = sum(weights)
    r = rng.random() * total
    acc = 0
    for i, w in enumerate(weights):
        acc += w
        if r <= acc:
            return i
    return len(weights) - 1
