"""The port's engine over the padded-ELL adjacency against the JAX
engine's, event by event: ``frontier`` in {on, auto} on seeded SO-like and
gMark-like streams with deletions, slide expiry with slot recycling and
vertex-axis growth (which re-packs the ELL rows). ``ell_cap=2`` and an
8-entry spill ring make rows spill, the ring drain and the rows re-pack;
``frontier_cap=4`` makes the fallback and the "auto" growth fire. Per
event: results, invalidations, conflict flags, frontier and adjacency
telemetry; at the end the dense device state. Tolerance 0.
"""
import numpy as np
import pytest

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import DenseRPQEngine as JaxDense
from repro.core.engine import RegisteredQuery as JaxQuery
from repro_torch.core import carry_reference_state
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, DenseRPQEngine, RegisteredQuery
from repro_torch.streaming.generators import so_like
from _torch_pairs import (SO_QUERIES, assert_state_equal, drive, engine_pair,
                          step, stream)


@pytest.mark.parametrize("kind", ["so", "gmark"])
@pytest.mark.parametrize("frontier", ["on", "auto"])
def test_engine_matches_per_event(frontier, kind):
    queries, tuples = stream(kind)
    je, te = engine_pair(queries, frontier, "ell")
    drive(je, te, tuples)
    assert_state_equal(je, te)
    assert te.n_slots > 8
    st = te.executor.frontier_stats
    assert st["dispatches"] > st["fallbacks"] >= 1
    assert st["delete_dispatches"] >= 1
    if frontier == "auto":
        assert st["cap"] > 4
    ast = te.executor.adjacency_stats
    assert ast["spill_drains"] >= 1 and ast["repacks"] >= 1
    assert ast["ell_cap"] > 2
    assert te.host_syncs >= te.executor.host_syncs >= te.steps


def test_flush_cadence_and_micro_batches():
    """"auto" at B=4 with no telemetry read until the end (the capacity
    grows at the reference's flush points), and delete_batch merging the
    cones of a batch of negative tuples."""
    _, tuples = stream("so")
    je, te = engine_pair(SO_QUERIES, "auto", "ell", n_slots=32, batch_size=4)
    inserts = [s.as_edge() for s in tuples if s.op == "+"]
    for i in range(0, 80, 4):
        assert je.insert_batch(inserts[i:i + 4]) == te.insert_batch(inserts[i:i + 4])
    batch = [inserts[3], inserts[9], inserts[17]]
    assert je.delete_batch(batch) == te.delete_batch(batch)
    for i in range(80, len(inserts), 4):
        assert je.insert_batch(inserts[i:i + 4]) == te.insert_batch(inserts[i:i + 4])
    assert_state_equal(je, te)


def test_live_registration_and_single_query_view():
    je, te = engine_pair(SO_QUERIES[:2], "auto", "ell", n_slots=16)
    _, tuples = stream("so")
    nxt = drive(je, te, tuples[:50], stats_every=0)
    spec = ("q5", "a2q . c2a . c2q*")
    assert je.register_query(JaxQuery(spec[0], jax_compile(spec[1]), 20.0)) == \
        te.register_query(RegisteredQuery(spec[0], compile_query(spec[1]), 20.0))
    je.deregister_query("q1")
    te.deregister_query("q1")
    drive(je, te, tuples[50:], next_expiry=nxt, stats_every=0)
    assert_state_equal(je, te)
    # the Q=1 view presents the dense slab and re-packs on assignment
    jd = JaxDense(jax_compile("a2q . c2a*"), 20.0, n_slots=8, batch_size=1,
                  backend="jnp", frontier="on", adj_layout="ell", ell_cap=2)
    td = DenseRPQEngine(compile_query("a2q . c2a*"), 20.0, n_slots=8,
                        batch_size=1, frontier="on", adj_layout="ell",
                        ell_cap=2, device="cpu")
    for sgt in so_like(n_vertices=10, n_edges=40, seed=2):
        assert jd.insert(*sgt.as_edge()) == td.insert(*sgt.as_edge())
    np.testing.assert_array_equal(td.arrays.adj.numpy(), np.asarray(jd.arrays.adj))
    td.arrays = td.arrays
    np.testing.assert_array_equal(td.executor.dense_adj().numpy(),
                                  np.asarray(jd.executor.dense_adj()))


def test_carry_reference_ell_state():
    """A JAX ELL engine's exported state loaded into an ELL port engine;
    both go on equal (results, dense state). The port packs the exported
    dense slab afresh, so its slot order and ring telemetry may differ
    from the JAX engine's own layout; those are not compared."""
    je, _ = engine_pair(SO_QUERIES, "auto", "ell", n_slots=32)
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in SO_QUERIES],
        n_slots=32, batch_size=1, frontier="auto", frontier_cap=4,
        adj_layout="ell", ell_cap=2, device="cpu")
    _, tuples = stream("so")
    half = len(tuples) // 2
    nxt = 2.0
    for sgt in tuples[:half]:
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        step(je, sgt)
    state = {k: np.asarray(v) for k, v in je.state_arrays().items()}
    carry_reference_state(te, state, je.interner_state(), je.results_state())
    assert te.per_query_results == je.per_query_results
    for sgt in tuples[half:]:
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            te.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        assert step(je, sgt) == step(te, sgt)
    np.testing.assert_array_equal(te.executor.dense_dist().numpy(),
                                  np.asarray(je.executor.dense_dist()))
    np.testing.assert_array_equal(te.executor.dense_adj().numpy(),
                                  np.asarray(je.executor.dense_adj()))
    assert te.per_query_results == je.per_query_results
