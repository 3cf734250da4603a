"""Shared helpers of the port-vs-JAX engine tests
(tests/test_torch_frontier.py, tests/test_torch_ell_engine.py,
tests/test_torch_rowsparse_engine.py, tests/test_torch_bucket_engine.py):
a pair of engines built alike, the per-event drive and the end-state
comparison."""
import numpy as np
import pytest
import torch

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import RegisteredQuery as JaxQuery
from repro.core.executor import LocalExecutor as JaxLocal
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.executor import LocalExecutor
from repro_torch.streaming.generators import gmark_like, so_like, with_deletions

LABELS = ("a", "b", "c")
SO_QUERIES = [("q1", "a2q . c2a*", "arbitrary"),
              ("q2", "(a2q | c2a | c2q)+", "arbitrary"),
              ("q3", "a2q . c2a* . c2q*", "simple"),
              ("q4", "a2q? . c2a*", "arbitrary")]
#: the row-sparse engine cases: executor options and stream length
RS = dict(dist_layout="row_sparse", dist_cap=16)
N_EVENTS = 70
GMARK_QUERIES = [("g1", "a . b*", "arbitrary"),
                 ("g2", "(a | b | c)*", "arbitrary"),
                 ("g3", "(a . b)+", "simple")]


@pytest.fixture
def one_torch_thread():
    """One intra-op torch thread for the test: the port's CPU tensors here
    are tiny, and parallel test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine_pair(queries, frontier, layout, window=20.0, n_slots=8, batch_size=1,
                backends=("jnp", None), **executor_kw):
    """A JAX engine and a port engine (CPU), each with an explicit
    executor: ``frontier_cap=4``, ``ell_cap=2`` and an 8-entry spill ring,
    so fallbacks, growth, spills, drains and re-packs fire;
    ``executor_kw`` adds or overrides executor options (the dist layout).
    ``backends`` are the JAX and the port backends (default ``"jnp"`` and
    the port's kernel backend)."""
    kw = {**dict(frontier=frontier, frontier_cap=4, adj_layout=layout,
                 ell_cap=2, spill_cap=8), **executor_kw}
    je = JaxEngine([JaxQuery(n, jax_compile(e), window, s) for n, e, s in queries],
                   n_slots=n_slots, batch_size=batch_size,
                   executor=JaxLocal(backends[0], **kw))
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), window, s) for n, e, s in queries],
        n_slots=n_slots, batch_size=batch_size,
        executor=LocalExecutor(backends[1], device="cpu", **kw))
    return je, te


def step(eng, sgt):
    """One sgt into one engine: its new pairs or its invalidations."""
    if sgt.op == "+":
        return eng.insert(sgt.src, sgt.dst, sgt.label, sgt.ts)
    return eng.delete(sgt.src, sgt.dst, sgt.label, sgt.ts)


def assert_dist_leaves_equal(je, te, tag=None):
    """The stored dist of both engines: the dense tensor, or the row-sparse
    dist leaf for leaf."""
    td, jd = te.executor.arrays.dist, je.executor.arrays.dist
    if isinstance(td, torch.Tensor):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=str(tag))
        return
    for name, a, b in zip(td._fields, td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} {tag}")


def drive(je, te, tuples, slide=2.0, stats_every=1, next_expiry=None,
          leaves=False):
    """Feed both engines the same sgts with slide-boundary expiry; assert
    per event the results, conflict flags, adjacency and dist telemetry
    (and with ``leaves`` the stored dist, leaf for leaf), and every
    ``stats_every`` events the frontier telemetry (reading it flushes the
    queued counters; 0 leaves the cadence alone). Returns the next expiry
    time."""
    nxt = slide if next_expiry is None else next_expiry
    for i, sgt in enumerate(tuples):
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            te.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += slide
        assert step(je, sgt) == step(te, sgt), (i, sgt)
        assert je.per_query_conflicted == te.per_query_conflicted, (i, sgt)
        assert te.executor.adjacency_stats == je.executor.adjacency_stats, i
        assert te.executor.dist_stats == je.executor.dist_stats, i
        if leaves:
            assert_dist_leaves_equal(je, te, (i, sgt))
        if stats_every and i % stats_every == 0:
            assert te.executor.frontier_stats == je.executor.frontier_stats, i
    return nxt


def assert_state_equal(je, te):
    """Dense device state, interner, results and every counter equal."""
    np.testing.assert_array_equal(te.executor.dense_dist().numpy(),
                                  np.asarray(je.executor.dense_dist()))
    np.testing.assert_array_equal(te.executor.dense_adj().numpy(),
                                  np.asarray(je.executor.dense_adj()))
    np.testing.assert_array_equal(te.batched_arrays.emitted.numpy(),
                                  np.asarray(je.batched_arrays.emitted))
    assert te.slot_of == je.slot_of
    assert te.per_query_results == je.per_query_results
    assert te.executor.frontier_stats == je.executor.frontier_stats
    assert te.executor.adjacency_stats == je.executor.adjacency_stats
    assert te.executor.dist_stats == je.executor.dist_stats
    assert (te.total_rounds, te.total_query_rounds) == \
        (je.total_rounds, je.total_query_rounds)
    assert te.executor.unmasked_query_rounds_total == \
        je.executor.unmasked_query_rounds_total


def stream(kind):
    """(queries, sgts) of a seeded SO-like or gMark-like stream with 6%
    deletions, ~20 vertices."""
    if kind == "so":
        return SO_QUERIES, list(with_deletions(
            so_like(n_vertices=24, n_edges=130, seed=3), ratio=0.06, seed=1))
    return GMARK_QUERIES, list(with_deletions(
        gmark_like(20, 130, list(LABELS), seed=4), ratio=0.06, seed=2))


def check_row_sparse_pair(frontier, layout):
    """Port and JAX row-sparse engines (32 slots, no growth, from
    ``dist_cap=16``) over the first ``N_EVENTS`` sgts of the SO-like
    stream, per event and leaf for leaf: rows overflow into the table,
    drains grow the capacity and re-pack."""
    queries, tuples = stream("so")
    je, te = engine_pair(queries, frontier, layout, n_slots=32, **RS)
    drive(je, te, tuples[:N_EVENTS], leaves=True)
    assert_state_equal(je, te)
    st = te.executor.dist_stats
    assert st["drains"] >= 1 and st["repacks"] >= 1 and st["dist_cap"] > 16
    assert st["lost"] == 0
    if frontier != "off":
        fst = te.executor.frontier_stats
        assert fst["dispatches"] > fst["fallbacks"] >= 1
        assert fst["delete_dispatches"] >= 1
