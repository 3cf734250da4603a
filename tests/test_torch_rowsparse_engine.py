"""The port's engine over the row-sparse dist against the JAX engine's, event
by event and leaf for leaf.

``frontier`` off, on and auto over the dense adjacency, on a seeded
SO-like stream with deletions and slide expiry
(tests/test_torch_rowsparse_ell.py runs the ELL adjacency,
tests/test_torch_rowsparse_regressions.py the local cases of
tests/test_sparse_dist.py); then the port's row-sparse engine against its
own dense one in every frontier and adjacency mode; and a JAX engine's
row-sparse state carried into a port engine leaf for leaf. Per event:
results, invalidations, conflict flags, dist, adjacency and frontier
telemetry, and the raw ``RowSparseDist`` leaves (stale ``idx`` of free
slots included). Tolerance 0: max and min never reassociate.
"""
import numpy as np
import pytest

from repro_torch.core import carry_reference_dist, carry_reference_state
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.executor import LocalExecutor
from _torch_pairs import (N_EVENTS, RS, SO_QUERIES, assert_dist_leaves_equal,
                          check_row_sparse_pair, engine_pair, step, stream)
from _torch_pairs import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("frontier", ["off", "on", "auto"])
def test_engine_matches_per_event(frontier):
    check_row_sparse_pair(frontier, "dense")


# -- the port against itself, and a carried state --------------------------------


@pytest.mark.parametrize("frontier", ["off", "on", "auto"])
@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_row_sparse_equals_dense_layout(frontier, layout):
    """The port's row-sparse engine against its dense one: per event the
    same results and invalidations, at the end the same dense dist, round
    counts and frontier telemetry (the frontier decisions do not depend on
    the dist layout)."""
    queries, tuples = stream("gmark")

    def engine(**kw):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
            n_slots=8, batch_size=1, executor=LocalExecutor(
                None, device="cpu", frontier=frontier, frontier_cap=4,
                adj_layout=layout, ell_cap=2, spill_cap=8, **kw))

    dense, sparse = engine(), engine(dist_layout="row_sparse", dist_cap=2)
    nxt = 2.0
    for i, sgt in enumerate(tuples):
        if sgt.ts >= nxt:
            dense.expire(sgt.ts)
            sparse.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        assert step(dense, sgt) == step(sparse, sgt), (i, sgt)
    assert np.array_equal(dense.executor.dense_dist().numpy(),
                          sparse.executor.dense_dist().numpy())
    assert dense.total_rounds == sparse.total_rounds
    assert dense.executor.frontier_stats == sparse.executor.frontier_stats
    assert sparse.executor.dist_stats["repacks"] >= 1


def test_carry_reference_row_sparse_state():
    """A JAX row-sparse engine's exported state, interner, results and its
    own RowSparseDist leaves (with the claim budget) carried into a port
    engine mid-stream; both go on equal, leaf for leaf."""
    je, te = engine_pair(SO_QUERIES, "on", "dense", n_slots=32, **RS)
    _, tuples = stream("so")
    tuples = tuples[:N_EVENTS]
    half = N_EVENTS // 2
    nxt = 2.0
    for sgt in tuples[:half]:
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        step(je, sgt)
    state = {k: np.asarray(v) for k, v in je.state_arrays().items()}
    carry_reference_state(te, state, je.interner_state(), je.results_state())
    carry_reference_dist(te, [np.asarray(x) for x in je.executor.arrays.dist],
                         budget=je.executor._dist_budget)
    assert_dist_leaves_equal(je, te, "carried")
    for i, sgt in enumerate(tuples[half:]):
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            te.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        assert step(je, sgt) == step(te, sgt), i
        assert_dist_leaves_equal(je, te, i)
    assert te.per_query_results == je.per_query_results
