"""The port's engine with the bucket backend (``BucketBackend(8)``) against
the JAX engine with the reference's bucket backend (``use_pallas=False``),
event by event, and against the port's own float engine.

Per event, in four layouts (dense adjacency with frontier off and auto,
ELL with frontier auto, ELL with the row-sparse dist): results,
invalidations, conflict flags, telemetry and the stored float32 dist (or
its row-sparse leaves), bit for bit, over a seeded SO-like stream with
deletions, slide expiry, slot recycling and growth. Then the port's own
form of the reference's guards (tests/test_backends.py:85-116, 222-294):
the bucket dist is the float dist mapped through the level grid, results
are a superset whose extras lie within one level step of the threshold;
and a JAX bucket engine's exported state carried over mid-stream.
Tolerance 0.
"""
import random

import numpy as np
import pytest

from repro.core.automaton import compile_query as jax_compile
from repro.core.backend import BucketBackend as JaxBucket
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import RegisteredQuery as JaxQuery
from repro_torch.core import carry_reference_state
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import BucketBackend
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from _torch_pairs import (RS, SO_QUERIES, assert_state_equal, drive, engine_pair,
                          one_torch_thread, step, stream)  # noqa: F401

N_LEVELS = 8
LAYOUTS = {"dense-off": ("off", "dense", {}), "dense-auto": ("auto", "dense", {}),
           "ell-auto": ("auto", "ell", {}), "ell-rowsparse-auto": ("auto", "ell", RS)}
N_EVENTS = 70

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _bucket_pair(frontier, layout, **kw):
    return engine_pair(
        SO_QUERIES, frontier, layout,
        backends=(JaxBucket(N_LEVELS, use_pallas=False), BucketBackend(N_LEVELS)),
        **kw)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_bucket_engine_matches_per_event(name):
    frontier, layout, extra = LAYOUTS[name]
    _, tuples = stream("so")
    je, te = _bucket_pair(frontier, layout, n_slots=32 if extra else 8, **extra)
    drive(je, te, tuples[:N_EVENTS], leaves=True)
    assert_state_equal(je, te)
    assert te.n_slots > 8 or extra                 # growth re-packed the state
    if frontier != "off":
        st = te.executor.frontier_stats
        assert st["dispatches"] > st["fallbacks"] >= 1
        assert st["delete_dispatches"] >= 1
    if extra:
        assert te.executor.dist_stats["drains"] >= 1


# ---------------------------------------------------------------------------
# the port's own guards: bucket engine vs the port's float engine
# ---------------------------------------------------------------------------

QUERIES = ["a*", "a . b*", "(a | b)*", "a . b* . c"]
LABELS = ["a", "b", "c"]


def _random_events(rng, n_vertices, n_edges, t_max):
    """tests/test_backends.py's stream: inserts with 15% deletions of live
    edges, at distinct integer times."""
    live, events = {}, []
    for t in sorted(rng.sample(range(1, t_max), k=min(n_edges, t_max - 1))):
        u, v = rng.randrange(n_vertices), rng.randrange(n_vertices)
        lab = rng.choice(LABELS)
        if live and rng.random() < 0.15:
            du, dv, dl = rng.choice(sorted(live))
            del live[(du, dv, dl)]
            events.append(("-", du, dv, dl, float(t)))
        else:
            live[(u, v, lab)] = t
            events.append(("+", u, v, lab, float(t)))
    return events


def _specs(rng, n_queries, window):
    specs = []
    for qi in range(n_queries):
        dfa = compile_query(rng.choice(QUERIES))
        semantics = ("simple" if dfa.has_containment_property
                     and rng.random() < 0.4 else "arbitrary")
        specs.append(RegisteredQuery(f"q{qi}", dfa, window, semantics))
    return specs


def _assert_grid_consistent(dist_f, dist_b, now, w_max):
    """The origin-free guard: every finite bucket entry is the grid ceil of
    the float entry, and every entry the bucket dropped lay at or below
    the current window origin."""
    step = np.float32(w_max) / np.float32(N_LEVELS)
    origin = np.float32(np.floor((np.float32(now) - np.float32(w_max)) / step) * step)
    expected = (np.ceil(dist_f / step) * step).astype(np.float32)
    finite_b = np.isfinite(dist_b)
    np.testing.assert_array_equal(dist_b[finite_b], expected[finite_b])
    assert np.all(dist_f[~finite_b] <= origin + 1e-4)


def _ports(specs, n_slots):
    ref = BatchedDenseRPQEngine(specs, n_slots=n_slots, batch_size=1,
                                backend="plain", device="cpu")
    eng = BatchedDenseRPQEngine(specs, n_slots=n_slots, batch_size=1,
                                backend=BucketBackend(N_LEVELS), device="cpu")
    return ref, eng


def test_bucket_dist_is_grid_mapped_float_dist():
    """At every event the port's bucket dist equals the port's float dist
    mapped through the level grid, elementwise."""
    rng = random.Random(3)
    window = 20.0
    ref, eng = _ports(_specs(rng, 2, window), 10)
    for i, (op, u, v, lab, ts) in enumerate(_random_events(rng, 5, 20, 55)):
        for e in (ref, eng):
            (e.insert if op == "+" else e.delete)(u, v, lab, ts)
            if i % 5 == 4:
                e.expire(ts)
        _assert_grid_consistent(ref.batched_arrays.dist.numpy(),
                                eng.batched_arrays.dist.numpy(),
                                ref.host_now, window)


def test_bucket_results_superset_with_bounded_boundary_error():
    """The bucket engine reports every float-valid pair, and an extra valid
    pair's true best bottleneck lies within one level step below its
    query's threshold."""
    rng = random.Random(11)
    window = 24.0
    step = window / N_LEVELS
    specs = _specs(rng, 3, window)
    ref, eng = _ports(specs, 12)
    finals = ref.finals_mask.numpy()
    n_extra = 0
    for i, (op, u, v, lab, ts) in enumerate(_random_events(rng, 6, 30, 80)):
        if op == "-":
            ref.delete(u, v, lab, ts)
            eng.delete(u, v, lab, ts)
            continue
        fr = ref.insert(u, v, lab, ts)
        eng.insert(u, v, lab, ts)
        for qi in range(3):
            assert fr[qi] <= eng.per_query_results[qi], (i, qi)
            vr, ve = ref.current_results(qi), eng.current_results(qi)
            assert vr <= ve, (i, qi, vr - ve)
            dist = ref.batched_arrays.dist[qi].numpy()
            best = np.where(finals[qi][None, None, :], dist, -np.inf).max(2)
            low = ref.host_now - specs[qi].window
            for (x, y) in ve - vr:
                b = best[ref.slot_of[x], ref.slot_of[y]]
                assert low - step - 1e-4 <= b <= low + 1e-4, (i, qi, (x, y), b)
                n_extra += 1
    for qi in range(3):
        assert ref.per_query_results[qi] <= eng.per_query_results[qi]
    assert n_extra > 0                     # the bound was exercised


def test_carry_reference_bucket_state():
    """A JAX bucket engine's exported state (canonical float32 between
    dispatches) loaded into a port bucket engine mid-stream: both go on
    bit-identically per event, results and stored dist."""
    _, tuples = stream("so")
    queries = SO_QUERIES
    je = JaxEngine([JaxQuery(n, jax_compile(e), 20.0, s) for n, e, s in queries],
                   n_slots=32, batch_size=1,
                   backend=JaxBucket(N_LEVELS, use_pallas=False))
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
        n_slots=32, batch_size=1, backend=BucketBackend(N_LEVELS), device="cpu")
    half = 50
    nxt = 2.0
    for sgt in tuples[:half]:
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        step(je, sgt)
    state = {k: np.asarray(v) for k, v in je.state_arrays().items()}
    carry_reference_state(te, state, je.interner_state(), je.results_state())
    drive(je, te, tuples[half:N_EVENTS + half], next_expiry=nxt, leaves=True)
    assert te.per_query_results == je.per_query_results
