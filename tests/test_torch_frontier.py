"""The port's frontier-restricted closure and deletion, over the dense and
the ELL adjacency, against the JAX package's.

Units first (the seed, the pack, one round's write-back, the closure and
the cone delete on both branches: frontier and overflow fallback), then
the engine event by event with ``frontier`` in {on, auto} over the dense
adjacency, on seeded SO-like and gMark-like streams with deletions, slide
expiry with slot recycling and vertex-axis growth
(tests/test_torch_ell_engine.py runs the same over the ELL adjacency).
``frontier_cap=4`` makes the fallback and the "auto" growth fire. Inputs
are numpy arrays from a seed; the JAX engine runs ``backend="jnp"``; the
tolerance is 0. Both packages run the same frontier algorithm, so even
the raw dist (window-dead entries included) must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.automaton import compile_query as jax_compile
from repro.core.sparse_adj import pack_ell as jax_pack_ell
from repro_torch.core import semiring as tsr
from repro_torch.core.automaton import compile_query
from repro_torch.core.sparse_adj import from_numpy, pack_ell
from _torch_pairs import (SO_QUERIES, assert_state_equal, drive, engine_pair,
                          stream)

NEG_INF = float("-inf")
EXPRS = ["a . b*", "(a | b | c)+", "a . b* . c*", "a? . b*", "a . b . c"]
LABELS = ("a", "b", "c")


# -- units --------------------------------------------------------------------


def _tables():
    jbtt = jsr.BatchedTransitionTable.from_dfas(
        [jax_compile(e) for e in EXPRS], LABELS)
    tbtt = tsr.BatchedTransitionTable.from_dfas(
        [compile_query(e) for e in EXPRS], LABELS, device="cpu")
    return jbtt, tbtt


def test_seed_pack_and_cone_units():
    """tests/test_frontier.py's unit cases: base rows and reaching rows are
    dirty, inert lanes are not, overflow counts survive the pack, the
    padding slots hold row 0."""
    dist = np.full((2, 6, 6, 2), NEG_INF, np.float32)
    dist[0, 3, 1, 0] = 5.0          # lane 0: row 3 reaches batch source 1
    dist[1, 2, 1, 0] = 5.0          # lane 1 is inert
    args = (np.array([1, 4]), np.array([True, False]), np.array([True, False]))
    t_args = [torch.from_numpy(x) for x in args]
    dirty = tsr.frontier_seed(torch.from_numpy(dist), *t_args)
    np.testing.assert_array_equal(
        dirty.numpy(), np.asarray(jsr.frontier_seed(
            jnp.asarray(dist), *[jnp.asarray(x) for x in args])))
    np.testing.assert_array_equal(dirty[0].numpy(),
                                  [False, True, False, True, False, False])
    assert not dirty[1].any()
    np.testing.assert_array_equal(
        tsr.delete_cone(torch.from_numpy(dist), *t_args).numpy(), dirty.numpy())
    for f_cap in (1, 2, 4, 8):
        rows, rowmask, cnt = tsr.pack_frontier(dirty, f_cap)
        jrows, jrowmask, jcnt = jsr.pack_frontier(jnp.asarray(dirty.numpy()),
                                                  f_cap)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(rowmask.numpy(), np.asarray(jrowmask))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert cnt.tolist() == [2, 0]


@pytest.mark.parametrize("seed", range(3))
def test_pack_frontier_random_masks(seed):
    rng = np.random.default_rng(seed)
    dirty = rng.random((5, 17)) < 0.3
    dirty[2] = True                       # a lane that overflows every cap
    for f_cap in (1, 3, 4, 16, 32):
        out = tsr.pack_frontier(torch.from_numpy(dirty), f_cap)
        ref = jsr.pack_frontier(jnp.asarray(dirty), f_cap)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_relax_round_write_back_folds_padded_row_zero():
    """Row 0 is a valid frontier row of lane 0 AND the padding of its
    empty slots: the write-back must fold both, as JAX's ``.at[].max``."""
    jbtt, tbtt = _tables()
    q, n, k = len(EXPRS), 7, jbtt.k
    rng = np.random.default_rng(3)
    adj = np.where(rng.random((4, n, n)) < 0.35,
                   rng.integers(1, 50, (4, n, n)).astype(np.float32), NEG_INF)
    adj = adj.astype(np.float32)
    dist = np.full((q, n, n, k), NEG_INF, np.float32)
    rows = np.zeros((q, 4), np.int64)
    rows[0, :2] = [0, 3]
    rowmask = np.zeros((q, 4), bool)
    rowmask[0, :2] = True
    rowmask[1, 0] = True                # lane 1: row 0 alone
    jd, jch = jsr.frontier_relax_round(jnp.asarray(dist), jnp.asarray(adj), jbtt,
                                       "jnp", jnp.asarray(rows),
                                       jnp.asarray(rowmask))
    td, tch = tsr.frontier_relax_round(torch.from_numpy(dist.copy()),
                                       torch.from_numpy(adj), tbtt, "plain",
                                       torch.from_numpy(rows),
                                       torch.from_numpy(rowmask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    assert np.isfinite(td.numpy()[0, 0]).any()


def _fixpoint_case(seed, n=9):
    """A closure at its fixpoint over a random adjacency, then a batch of
    B=3 edges (one masked): the state a frontier dispatch starts from."""
    jbtt, tbtt = _tables()
    q, k = len(EXPRS), jbtt.k
    rng = np.random.default_rng(seed)
    adj = np.where(rng.random((4, n, n)) < 0.12,
                   rng.integers(1, 50, (4, n, n)).astype(np.float32), NEG_INF)
    adj = adj.astype(np.float32)
    dist0 = np.full((q, n, n, k), NEG_INF, np.float32)
    dist, _, _ = jsr.batched_closure(jnp.asarray(dist0), jnp.asarray(adj),
                                     jbtt, "jnp")
    src = rng.integers(0, n, (3,))
    dst = rng.integers(0, n, (3,))
    lab = rng.integers(0, 3, (3,))
    smask = np.array([True, True, False])
    return jbtt, tbtt, adj, np.asarray(dist), src, dst, lab, smask


def _adj_forms(adj, layout):
    """(JAX operand, port operand) for a dense slab in ``layout``."""
    if layout == "dense":
        return jnp.asarray(adj), torch.from_numpy(adj.copy())
    cap = max(int((adj > NEG_INF).sum(-1).max()), 1)
    cap = 1 << (cap - 1).bit_length()
    jell = jax_pack_ell(adj, cap, 8)
    return (type(jell)(*[jnp.asarray(x) for x in jell]),
            from_numpy(pack_ell(adj, cap, 8), "cpu"))


def _assert_frontier_equal(jout, tout):
    jd, jr, jqr, jst = jout
    td, tr, tqr, tst = tout
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == int(jr)
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    assert tst == tsr.FrontierStats(int(jst.seed_rows), int(jst.max_lane_rows),
                                    int(jst.rows_relaxed), bool(jst.fell_back))


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("f_cap", [1, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_closure_matches(seed, f_cap, layout):
    """f_cap=1 overflows (the dense fallback), f_cap=16 does not."""
    jbtt, tbtt, adj, dist, src, dst, lab, smask = _fixpoint_case(seed)
    adj2 = adj.copy()
    for s, d, l, m in zip(src, dst, lab, smask):
        if m:
            adj2[l, s, d] = max(adj2[l, s, d], 60.0 + s)
    qmask = np.array([True, True, False, True, True])
    ja, ta = _adj_forms(adj2, layout)
    jout = jsr.frontier_closure(jnp.asarray(dist), ja, jbtt, "jnp",
                                jnp.asarray(src), jnp.asarray(smask), f_cap,
                                query_mask=jnp.asarray(qmask))
    tout = tsr.frontier_closure(torch.from_numpy(dist.copy()), ta, tbtt,
                                "plain", torch.from_numpy(src),
                                torch.from_numpy(smask), f_cap,
                                query_mask=torch.from_numpy(qmask))
    _assert_frontier_equal(jout, tout)
    assert tout[3].fell_back == (f_cap == 1)


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("f_cap", [1, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_frontier_delete_matches(seed, f_cap, layout):
    jbtt, tbtt, adj, dist, src, dst, lab, smask = _fixpoint_case(seed)
    # delete edges that exist: the batch's slots re-aimed at live entries
    live = np.argwhere(adj > NEG_INF)[[0, 3, 5]]
    lab, src, dst = live[:, 0], live[:, 1], live[:, 2]
    adj2 = adj.copy()
    for s, d, l, m in zip(src, dst, lab, smask):
        if m:
            adj2[l, s, d] = NEG_INF
    ja, ta = _adj_forms(adj2, layout)
    jout = jsr.frontier_delete(jnp.asarray(dist), ja, jbtt, "jnp",
                               jnp.asarray(src), jnp.asarray(smask), f_cap)
    tout = tsr.frontier_delete(torch.from_numpy(dist.copy()), ta, tbtt,
                               "plain", torch.from_numpy(src),
                               torch.from_numpy(smask), f_cap)
    _assert_frontier_equal(jout, tout)
    assert tout[3].fell_back == (f_cap == 1)


@pytest.mark.parametrize("n", [7, 12])
def test_ell_round_and_closure_match_dense(n):
    """The dense batched round over an ELL adjacency (base term folded
    straight off the slots and the ring) against the reference's."""
    jbtt, tbtt = _tables()
    q, k = len(EXPRS), jbtt.k
    rng = np.random.default_rng(n)
    adj = np.where(rng.random((4, n, n)) < 0.25,
                   rng.integers(1, 50, (4, n, n)).astype(np.float32), NEG_INF)
    adj = adj.astype(np.float32)
    dist = np.full((q, n, n, k), NEG_INF, np.float32)
    mask = np.array([True, False, True, True, True])
    ja, ta = _adj_forms(adj, "ell")
    jd, jr, jqr = jsr.batched_closure(jnp.asarray(dist), ja, jbtt, "jnp",
                                      query_mask=jnp.asarray(mask))
    td, tr, tqr = tsr.batched_closure(torch.from_numpy(dist.copy()), ta, tbtt,
                                      "plain", query_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == int(jr)
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    dense_td, *_ = tsr.batched_closure(torch.from_numpy(dist.copy()),
                                       torch.from_numpy(adj), tbtt, "plain",
                                       query_mask=torch.from_numpy(mask))
    assert torch.equal(td, dense_td)


# -- engine, event by event, dense adjacency ------------------------------------


@pytest.mark.parametrize("kind", ["so", "gmark"])
@pytest.mark.parametrize("frontier", ["on", "auto"])
def test_engine_matches_per_event(frontier, kind):
    """8 slots against ~20 vertices: recycling and vertex-axis growth; 6%
    deletions; per event the results, invalidations, conflict flags and
    the frontier telemetry; at the end the device state."""
    queries, tuples = stream(kind)
    je, te = engine_pair(queries, frontier, "dense")
    drive(je, te, tuples)
    assert_state_equal(je, te)
    assert te.n_slots > 8
    st = te.executor.frontier_stats
    assert st["dispatches"] > st["fallbacks"] >= 1
    assert st["delete_dispatches"] >= 1
    if frontier == "auto":
        assert st["cap"] > 4
    assert te.host_syncs >= te.executor.host_syncs >= te.steps


def test_flush_cadence_and_micro_batches():
    """"auto" at B=4 with no telemetry read until the end: the capacity
    grows at the flushes every 64 pending dispatches, as in the reference,
    and delete_batch merges the cones of a batch of negative tuples."""
    _, tuples = stream("so")
    je, te = engine_pair(SO_QUERIES, "auto", "dense", n_slots=32, batch_size=4)
    inserts = [s.as_edge() for s in tuples if s.op == "+"]
    for i in range(0, 80, 4):
        assert je.insert_batch(inserts[i:i + 4]) == te.insert_batch(inserts[i:i + 4])
    batch = [inserts[3], inserts[9], inserts[17]]
    assert je.delete_batch(batch) == te.delete_batch(batch)
    for i in range(80, len(inserts), 4):
        assert je.insert_batch(inserts[i:i + 4]) == te.insert_batch(inserts[i:i + 4])
    assert_state_equal(je, te)
