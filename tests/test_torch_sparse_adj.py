"""The port's padded-ELL adjacency against the JAX package's, leaf for leaf.

Every mutation (insert with per-row overflow into the spill ring, ring
merge and append, delete, expire, slot clearing) runs on both packages
from the same seeded inputs, and all seven leaves must be equal after each
step — slot placement and ring order included, since they decide when
later inserts spill. The dense slab is the second oracle, as in
tests/test_sparse_adj.py. The tolerance is 0.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core import sparse_adj as jsa
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse_adj as tsa

NEG_INF = float("-inf")


def _random_dense(rng, l=3, n=10, density=0.15):
    adj = np.full((l, n, n), NEG_INF, np.float32)
    for _ in range(int(l * n * n * density)):
        adj[rng.randrange(l), rng.randrange(n), rng.randrange(n)] = float(
            rng.randrange(1, 50))
    return adj


# the reference's mutations, compiled once per test shape (they are traced
# loops, slow to run op by op)
J_INSERT = jax.jit(jsa.ell_insert)
J_DELETE = jax.jit(jsa.ell_delete)


def _leaves(ell):
    return [np.asarray(x) for x in ell]


def _assert_leaves_equal(jell, tell, msg=""):
    for name, a, b in zip(jsa.EllAdjacency._fields, _leaves(jell), _leaves(tell)):
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {msg}")


def _to_port(jell):
    return tsa.from_numpy(tsa.EllAdjacency(*_leaves(jell)), "cpu")


@pytest.mark.parametrize("seed", range(4))
def test_pack_densify_round_trip(seed):
    rng = random.Random(seed)
    adj = _random_dense(rng)
    cap = int(max((adj > NEG_INF).sum(axis=-1).max(), 1)) * 2
    jell = jsa.pack_ell(adj, cap, 16)
    tell = tsa.pack_ell(adj, cap, 16)
    _assert_leaves_equal(jell, tell)
    dev = tsa.pack_ell_dense(torch.from_numpy(adj), cap, 16)
    _assert_leaves_equal(jell, dev)
    np.testing.assert_array_equal(tsa.ell_to_dense(dev).numpy(), adj)
    assert int(tsa.ell_max_degree(dev)) == int(jsa.ell_max_degree(jell)) == \
        int((adj > NEG_INF).sum(axis=-1).max())
    assert int(tsa.ell_live_edges(dev)) == int(jsa.ell_live_edges(jell))


def test_pack_rejects_overfull_rows():
    adj = np.full((1, 4, 4), 5.0, np.float32)  # degree 4 everywhere
    with pytest.raises(ValueError):
        tsa.pack_ell(adj, 2, 8)
    with pytest.raises(ValueError):
        tsa.pack_ell_dense(torch.from_numpy(adj), 2, 8)
    tsa.pack_ell(adj, 4, 8)
    tsa.pack_ell_dense(torch.from_numpy(adj), 4, 8)


def _mutate(rng, jell, tell, dense, step, n_rows, n, l):
    """One random insert/delete/expire on both packages and the dense
    oracle (test_sparse_adj.py's mix). Returns the new states."""
    u, v, lab = rng.randrange(n_rows), rng.randrange(n), rng.randrange(l)
    t = float(step + 1)
    op = rng.random()
    if op < 0.6:
        dense[lab, u, v] = max(dense[lab, u, v], t)
        jell = J_INSERT(jell, jnp.asarray([u]), jnp.asarray([v]),
                              jnp.asarray([lab]), jnp.asarray([t], jnp.float32),
                              jnp.asarray([True]))
        tell = tsa.ell_insert(tell, [u], [v], [lab], torch.tensor([t]), [True])
    elif op < 0.8:
        dense[lab, u, v] = NEG_INF
        jell = J_DELETE(jell, jnp.asarray([u]), jnp.asarray([v]),
                              jnp.asarray([lab]), jnp.asarray([True]))
        tell = tsa.ell_delete(tell, [u], [v], [lab], [True])
    else:
        low = t - 20.0
        dense[dense <= low] = NEG_INF
        jell = jsa.ell_expire(jell, jnp.asarray(low, jnp.float32))
        tell = tsa.ell_expire(tell, torch.tensor(low))
    return jell, tell


@pytest.mark.parametrize("seed", range(3))
def test_mutations_match_reference_leaf_for_leaf(seed):
    """test_sparse_adj.py's 60 random single-event mutations on a tiny
    capacity (rows overflow into the ring), with the raw leaves of both
    packages and the dense oracle compared after every step."""
    rng = random.Random(seed)
    l, n, cap = 2, 8, 2
    dense = np.full((l, n, n), NEG_INF, np.float32)
    jell = jsa.pack_ell(dense, cap, 32)
    tell = _to_port(jell)
    for step in range(60):
        jell, tell = _mutate(rng, jell, tell, dense, step, n, n, l)
        _assert_leaves_equal(jell, tell, f"step {step}")
        np.testing.assert_array_equal(tsa.ell_to_dense(tell).numpy(), dense,
                                      err_msg=f"step {step}")
    inc_dense = np.maximum(dense.max(axis=(0, 2)), dense.max(axis=(0, 1)))
    np.testing.assert_array_equal(tsa.ell_incident(tell).numpy(), inc_dense)
    np.testing.assert_array_equal(tsa.ell_incident(tell).numpy(),
                                  np.asarray(jsa.ell_incident(jell)))
    assert int(tell.spill_ptr) > 0, "the tiny cap should have used the ring"
    assert int(tsa.ell_max_degree(tell)) == int(jsa.ell_max_degree(jell))
    assert int(tsa.ell_live_edges(tell)) == int(jsa.ell_live_edges(jell))


@pytest.mark.parametrize("seed", range(3))
def test_crowded_rows_keep_every_edge(seed):
    """The same mix on four rows only, so that rows stay full and the ring
    takes many edges. The port must equal the dense oracle at every step.
    It equals the JAX package leaf for leaf until the reference's ring
    match takes a free entry past the cursor for the triple (slot 0,
    slot 0, label 0) — see ``ell_insert`` — after which the reference can
    lose that edge; from that step on only the oracle is compared."""
    rng = random.Random(seed)
    l, n, cap = 2, 8, 2
    dense = np.full((l, n, n), NEG_INF, np.float32)
    jell = jsa.pack_ell(dense, cap, 32)
    tell = _to_port(jell)
    same = True
    for step in range(60):
        jell, tell = _mutate(rng, jell, tell, dense, step, 4, n, l)
        np.testing.assert_array_equal(tsa.ell_to_dense(tell).numpy(), dense,
                                      err_msg=f"step {step}")
        same = same and int(jell.spill_ptr) == int(tell.spill_ptr)
        if same:
            _assert_leaves_equal(jell, tell, f"step {step}")


def test_ring_match_ignores_the_free_tail():
    """Row (label 0, slot 0) full at capacity 1: inserting (0, 0, label 0)
    must append to the ring, and a later append must not overwrite it."""
    l, n = 1, 4
    jell = jsa.pack_ell(np.full((l, n, n), NEG_INF, np.float32), 1, 8)
    tell = _to_port(jell)
    events = [(0, 1, 1.0), (0, 0, 2.0), (0, 2, 3.0)]   # (u, v, ts), label 0
    for u, v, t in events:
        jell = J_INSERT(jell, jnp.asarray([u]), jnp.asarray([v]),
                              jnp.asarray([0]), jnp.asarray([t], jnp.float32),
                              jnp.asarray([True]))
        tell = tsa.ell_insert(tell, [u], [v], [0], torch.tensor([t]), [True])
    dense = tsa.ell_to_dense(tell).numpy()
    assert dense[0, 0, 1] == 1.0 and dense[0, 0, 0] == 2.0 and dense[0, 0, 2] == 3.0
    assert int(tell.spill_ptr) == 2
    # the reference merged (0, 0) into the free entry at its cursor and
    # then appended (0, 2) over it
    assert int(jell.spill_ptr) == 1
    assert np.asarray(jsa.ell_to_dense(jell))[0, 0, 0] == NEG_INF


def test_batch_insert_delete_with_duplicates_masks_and_ring_merge():
    """Batched events in one call: a duplicated triple, masked padding,
    overfull rows that append to the ring, a later batch that merges into
    a ringed triple, and a batched delete that clears row and ring copies."""
    l, n, cap = 2, 6, 1
    jell = jsa.pack_ell(np.full((l, n, n), NEG_INF, np.float32), cap, 8)
    tell = _to_port(jell)
    batches = [
        # (src, dst, lab, ts, mask)
        ([0, 0, 0, 1, 3], [1, 2, 1, 4, 5], [0, 0, 0, 1, 1],
         [1.0, 2.0, 3.0, 4.0, 9.0], [True, True, True, True, False]),
        ([0, 0, 1, 1], [2, 3, 5, 4], [0, 0, 1, 1],
         [5.0, 6.0, 7.0, 3.0], [True, True, True, True]),
        ([0, 2, 0, 0], [2, 2, 3, 3], [0, 1, 0, 0],
         [8.0, 8.5, 2.0, 11.0], [True, True, True, False]),
    ]
    for src, dst, lab, ts, mask in batches:
        jell = J_INSERT(jell, jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(lab), jnp.asarray(ts, jnp.float32),
                              jnp.asarray(mask))
        tell = tsa.ell_insert(tell, np.asarray(src), np.asarray(dst),
                              np.asarray(lab), torch.tensor(ts),
                              np.asarray(mask))
        _assert_leaves_equal(jell, tell)
    # (0, 2, l=0) was appended to the ring by batch 2 and merged by batch 3
    ring = list(zip(np.asarray(tell.spill_src), np.asarray(tell.spill_dst),
                    np.asarray(tell.spill_lab), np.asarray(tell.spill_ts)))
    assert (0, 2, 0, 8.0) in ring and int(tell.spill_ptr) >= 3
    src, dst, lab, mask = [0, 0, 1, 2], [2, 1, 5, 2], [0, 0, 1, 1], \
        [True, True, True, False]
    jell = J_DELETE(jell, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(lab), jnp.asarray(mask))
    tell = tsa.ell_delete(tell, np.asarray(src), np.asarray(dst),
                          np.asarray(lab), np.asarray(mask))
    _assert_leaves_equal(jell, tell)
    # the input state is left as it was (the port's mutations are functional)
    before = _to_port(jsa.pack_ell(np.full((l, n, n), NEG_INF, np.float32),
                                   cap, 8))
    tsa.ell_insert(before, [0], [1], [0], torch.tensor([1.0]), [True])
    assert int(before.spill_ptr) == 0 and bool(torch.isneginf(before.ts).all())


@pytest.mark.parametrize("seed", range(3))
def test_clear_slots_label_rows_and_frontier_rows(seed):
    rng = np.random.default_rng(seed)
    l, n, cap, s = 3, 9, 2, 8
    idx = rng.integers(0, n, (l, n, cap)).astype(np.int32)
    ts = np.where(rng.random((l, n, cap)) < 0.6,
                  rng.integers(1, 40, (l, n, cap)).astype(np.float32), NEG_INF)
    spill = [rng.integers(0, hi, (s,)).astype(np.int32) for hi in (n, n, l)]
    spill_ts = np.where(rng.random(s) < 0.7,
                        rng.integers(1, 40, (s,)).astype(np.float32), NEG_INF)
    leaves = (idx, ts, *spill, spill_ts, np.int32(5))
    jell = jsa.EllAdjacency(*[jnp.asarray(x) for x in leaves])
    tell = tsa.from_numpy(tsa.EllAdjacency(*leaves), "cpu")
    np.testing.assert_array_equal(tsa.ell_to_dense(tell).numpy(),
                                  np.asarray(jsa.ell_to_dense(jell)))
    dead = rng.random(n) < 0.3
    _assert_leaves_equal(jsa.ell_clear_slots(jell, jnp.asarray(dead)),
                         tsa.ell_clear_slots(tell, torch.from_numpy(dead)))
    labs = rng.integers(0, l, (5,))
    np.testing.assert_array_equal(
        tsa.ell_label_rows(tell, torch.from_numpy(labs), NEG_INF).numpy(),
        np.asarray(jsa.ell_label_rows(jell, jnp.asarray(labs), NEG_INF)))
    rows = rng.integers(0, n, (5, 3))
    np.testing.assert_array_equal(
        tsa.ell_rows_dense(tell, torch.from_numpy(labs),
                           torch.from_numpy(rows), NEG_INF).numpy(),
        np.asarray(jsa.ell_rows_dense(jell, jnp.asarray(labs),
                                      jnp.asarray(rows), NEG_INF)))


@pytest.mark.parametrize("seed", range(2))
def test_gathered_seed_matches_dense_seed(seed):
    rng = np.random.default_rng(seed)
    q, n, k, b = 3, 9, 4, 5
    dist = np.where(rng.random((q, n, n, k)) < 0.3,
                    rng.integers(1, 30, (q, n, n, k)).astype(np.float32),
                    NEG_INF).astype(np.float32)
    src = rng.integers(0, n, (b,))
    smask = np.array([True, True, False, True, False])
    qmask = np.array([True, False, True])
    ref = np.asarray(jsr.frontier_seed(jnp.asarray(dist), jnp.asarray(src),
                                       jnp.asarray(smask), jnp.asarray(qmask)))
    args = (torch.from_numpy(dist), torch.from_numpy(src),
            torch.from_numpy(smask), torch.from_numpy(qmask))
    np.testing.assert_array_equal(tsr.frontier_seed_gathered(*args).numpy(), ref)
    np.testing.assert_array_equal(tsr.frontier_seed(*args).numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jsr.frontier_seed_gathered(
            jnp.asarray(dist), jnp.asarray(src), jnp.asarray(smask),
            jnp.asarray(qmask))), ref)
