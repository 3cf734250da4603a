"""The port's batched dense engine against the JAX engine, event by event:
the same new result pairs and deletion invalidations per lane, the same
conflict flags and, at the end, the same device state. The JAX engine runs
``backend="jnp"`` (the repo's own suite pins it equal to ``pallas``); the
port runs its default backend, whose wrapper takes the plain version on
CPU tensors. Streams come from the seeded generators; the tolerance is 0.
"""
import numpy as np
import pytest
import torch

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import DenseRPQEngine as JaxDense
from repro.core.engine import RegisteredQuery as JaxQuery
from repro_torch.core import carry_reference_state
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, DenseRPQEngine, RegisteredQuery
from repro_torch.streaming.generators import so_like, with_deletions

QUERIES = [("q1", "a2q . c2a*", "arbitrary"),
           ("q2", "(a2q | c2a | c2q)+", "arbitrary"),
           ("q3", "a2q . c2a* . c2q*", "simple"),
           ("q4", "a2q? . c2a*", "arbitrary")]


def _pair(queries, window=20.0, n_slots=8, batch_size=1):
    je = JaxEngine([JaxQuery(n, jax_compile(e), window, s) for n, e, s in queries],
                   n_slots=n_slots, batch_size=batch_size, backend="jnp")
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), window, s) for n, e, s in queries],
        n_slots=n_slots, batch_size=batch_size, device="cpu")
    return je, te


def _step(eng, sgt):
    if sgt.op == "+":
        return eng.insert(sgt.src, sgt.dst, sgt.label, sgt.ts)
    return eng.delete(sgt.src, sgt.dst, sgt.label, sgt.ts)


def _drive(je, te, tuples, slide=2.0, next_expiry=None):
    """Feed both engines the same sgts with slide-boundary expiry; assert
    per-event equality. Returns the next expiry time."""
    nxt = slide if next_expiry is None else next_expiry
    for i, sgt in enumerate(tuples):
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            te.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += slide
        a, b = _step(je, sgt), _step(te, sgt)
        assert a == b, (i, sgt)
        assert je.per_query_conflicted == te.per_query_conflicted, (i, sgt)
    return nxt


def _assert_state_equal(je, te):
    ja, ta = je.batched_arrays, te.batched_arrays
    np.testing.assert_array_equal(ta.adj.numpy(), np.asarray(ja.adj))
    np.testing.assert_array_equal(ta.dist.numpy(), np.asarray(ja.dist))
    np.testing.assert_array_equal(ta.emitted.numpy(), np.asarray(ja.emitted))
    assert float(ta.now) == float(np.asarray(ja.now))
    assert te.slot_of == je.slot_of
    assert te.per_query_results == je.per_query_results
    assert (te.total_rounds, te.total_query_rounds) == \
        (je.total_rounds, je.total_query_rounds)
    assert te.executor.unmasked_query_rounds_total == \
        je.executor.unmasked_query_rounds_total


def test_inserts_deletions_expiry_recycling_and_growth():
    """8 slots against ~24 vertices: slide expiry recycles slots and the
    vertex axis grows on demand; 5% of the sgts are deletions."""
    je, te = _pair(QUERIES, n_slots=8)
    stream = with_deletions(so_like(n_vertices=24, n_edges=140, seed=3),
                            ratio=0.05, seed=1)
    _drive(je, te, list(stream))
    assert te.n_slots == je.n_slots > 8
    _assert_state_equal(je, te)
    assert any(te.per_query_results)
    assert te.host_syncs >= te.executor.host_syncs >= te.steps


def test_micro_batches_and_window_boundary():
    """B=4 micro-batches, and the strict-> window boundary in float32."""
    je, te = _pair(QUERIES[:2], window=3.0, n_slots=16, batch_size=4)
    stream = so_like(n_vertices=12, n_edges=60, seed=9, rate=4.0)
    edges = [s.as_edge() for s in stream]
    for i in range(0, len(edges), 6):
        assert je.insert_batch(edges[i:i + 6]) == te.insert_batch(edges[i:i + 6])
    # an edge exactly one window old is expired (strict >)
    je.insert("u", "v", "a2q", 100.0)
    te.insert("u", "v", "a2q", 100.0)
    je.expire(103.0)
    te.expire(103.0)
    assert je.current_results(0) == te.current_results(0) == set()
    _assert_state_equal(je, te)


def test_live_register_and_deregister():
    je, te = _pair(QUERIES[:2], n_slots=16)
    tuples = list(with_deletions(so_like(n_vertices=14, n_edges=120, seed=5),
                                 ratio=0.03, seed=2))
    nxt = _drive(je, te, tuples[:40])
    spec = ("q5", "a2q . c2a . c2q*", "arbitrary")
    init_j = je.register_query(JaxQuery(spec[0], jax_compile(spec[1]), 20.0))
    init_t = te.register_query(RegisteredQuery(spec[0], compile_query(spec[1]), 20.0))
    assert init_j == init_t
    spec = ("q6", "a2q . c2a* . c2q*", "simple")
    assert je.register_query(JaxQuery(spec[0], jax_compile(spec[1]), 20.0, "simple")) == \
        te.register_query(RegisteredQuery(spec[0], compile_query(spec[1]), 20.0, "simple"))
    nxt = _drive(je, te, tuples[40:80], next_expiry=nxt)
    je.deregister_query("q1")
    te.deregister_query("q1")
    assert [s and s.name for s in je.lane_specs] == \
        [s and s.name for s in te.lane_specs]
    _drive(je, te, tuples[80:], next_expiry=nxt)
    assert te.q_cap == je.q_cap
    _assert_state_equal(je, te)


def test_carry_reference_state_mid_stream():
    """Run the JAX engine over the first half, hand its exported state to
    a fresh port engine, then drive both over the second half."""
    je, _ = _pair(QUERIES, n_slots=32)
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in QUERIES],
        n_slots=32, batch_size=1, device="cpu")
    tuples = list(with_deletions(so_like(n_vertices=20, n_edges=120, seed=11),
                                 ratio=0.04, seed=4))
    half = len(tuples) // 2
    nxt = 2.0
    for sgt in tuples[:half]:
        if sgt.ts >= nxt:
            je.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        _step(je, sgt)
    state = {k: np.asarray(v) for k, v in je.state_arrays().items()}
    carry_reference_state(te, state, je.interner_state(), je.results_state())
    # the clock round-trips through the float32 state, as in a JAX restore
    assert te.host_now == float(np.float32(je.host_now))
    assert te.per_query_results == je.per_query_results
    _drive(je, te, tuples[half:], next_expiry=nxt)
    np.testing.assert_array_equal(te.batched_arrays.dist.numpy(),
                                  np.asarray(je.batched_arrays.dist))
    assert te.per_query_results == je.per_query_results
    with pytest.raises(ValueError):
        small = BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in QUERIES],
            n_slots=8, device="cpu")
        carry_reference_state(small, state, je.interner_state(),
                              je.results_state())


def test_single_query_view_and_state_export():
    jd = JaxDense(jax_compile("a2q . c2a*"), 20.0, n_slots=8, batch_size=1,
                  backend="jnp")
    td = DenseRPQEngine(compile_query("a2q . c2a*"), 20.0, n_slots=8,
                        batch_size=1, device="cpu")
    for sgt in so_like(n_vertices=10, n_edges=40, seed=2):
        assert jd.insert(sgt.src, sgt.dst, sgt.label, sgt.ts) == \
            td.insert(sgt.src, sgt.dst, sgt.label, sgt.ts)
    assert jd.results == td.results
    assert jd.index_size() == td.index_size()
    assert jd.retained_edges() == td.retained_edges()
    np.testing.assert_array_equal(td.arrays.dist.numpy(),
                                  np.asarray(jd.arrays.dist))
    exported = td.state_arrays()
    assert exported["dist"].shape == (1, td.n_slots, td.n_slots, td.k)
    assert td.interner_state() == jd.interner_state()
    assert td.results_state() == jd.results_state()


def test_unported_options_and_device_default():
    q = [RegisteredQuery("q", compile_query("a*"), 5.0)]
    for kw, item in (({"frontier": "on"}, "A6"), ({"adj_layout": "ell"}, "A8"),
                     ({"dist_layout": "row_sparse"}, "A9")):
        with pytest.raises(NotImplementedError, match=item):
            BatchedDenseRPQEngine(q, device="cpu", **kw)
    with pytest.raises(ValueError):
        BatchedDenseRPQEngine(q, device="cpu", frontier="sideways")
    if torch.cuda.is_available():
        assert BatchedDenseRPQEngine(q).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedDenseRPQEngine(q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conflict_probe_matches(seed):
    """The boolean conflict probe against the JAX einsum count."""
    import jax.numpy as jnp
    from repro.core.engine import _conflict_possible as jax_probe
    from repro_torch.core.engine import _conflict_possible

    rng = np.random.default_rng(seed)
    q, n, k = 5, 6, 4
    dist = rng.uniform(0, 10, (q, n, n, k)).astype(np.float32)
    dist[rng.random(dist.shape) > 0.15] = -np.inf
    nc = rng.random((q, k, k)) < 0.3
    nc[0] = False                      # lane 0 can never conflict
    low = rng.uniform(0, 5, (q,)).astype(np.float32)
    ref = np.asarray(jax_probe(jnp.asarray(dist), jnp.asarray(nc), jnp.asarray(low)))
    got = _conflict_possible(torch.from_numpy(dist), torch.from_numpy(nc),
                             torch.from_numpy(low)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any() and not ref[0]


def test_duplicate_edges_within_a_batch_keep_the_newest():
    """One (label, u, v) twice in a micro-batch, plus padding rows: the
    adjacency keeps the max timestamp (a summing scatter would not)."""
    je, te = _pair(QUERIES[:2], n_slots=8, batch_size=4)
    batch = [("x", "y", "a2q", 1.0), ("x", "y", "a2q", 2.5), ("y", "z", "c2a", 2.0)]
    assert je.insert_batch(batch) == te.insert_batch(batch)
    batch = [("x", "y", "a2q", 3.0), ("x", "y", "a2q", 2.75)]
    assert je.insert_batch(batch) == te.insert_batch(batch)
    _assert_state_equal(je, te)
    assert float(te.batched_arrays.adj.max()) == 3.0


# (0.18, 1631.707) and (4.59, 672.234): float32 arithmetic keeps the edge
# alive at t0 + window where float64 host arithmetic expires it
@pytest.mark.parametrize("window,t0", [(10.0, 5.0), (0.3, 0.1), (0.18, 1631.707),
                                       (4.59, 672.234)])
def test_window_boundary_in_float32(window, t0):
    """Events at t0 + window (computed in float64 on the host) land on the
    float32 clock on either side of the boundary; both engines must agree
    on expiry, emission and deletion invalidation there."""
    for op in ("expire", "insert", "delete"):
        je, te = _pair([("q", "a2q . c2a*", "arbitrary")], window=window)
        for eng in (je, te):
            eng.insert("u", "v", "a2q", t0)
            eng.insert("v", "w", "c2a", t0 + window / 3)
        t1 = t0 + window
        if op == "expire":
            je.expire(t1)
            te.expire(t1)
        elif op == "insert":
            assert je.insert("p", "q", "a2q", t1) == te.insert("p", "q", "a2q", t1)
        else:
            assert je.delete("v", "w", "c2a", t1) == te.delete("v", "w", "c2a", t1)
        assert je.current_results(0) == te.current_results(0)
        _assert_state_equal(je, te)
