"""The port's batched closure against the JAX package's: the same
transition table, the same dist after every round and at the fixpoint,
the same ``rounds`` and ``query_rounds``, with and without a query mask.
Inputs are numpy arrays from a seed; the tolerance is 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.automaton import compile_query as jax_compile
from repro_torch.core import semiring as tsr
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import (KNOWN_BACKENDS, KernelBackend,
                                          PlainBackend, resolve_backend)

EXPRS = ["a . b*", "(a | b | c)+", "a . b* . c*", "a? . b*", "a . b . c"]
LABELS = ("a", "b", "c")


def _tables(exprs, n_inert=0):
    jd = [jax_compile(e) for e in exprs]
    td = [compile_query(e) for e in exprs]
    jbtt = jsr.BatchedTransitionTable.from_dfas(jd, LABELS)
    tbtt = tsr.BatchedTransitionTable.from_dfas(td, LABELS, device="cpu")
    return jbtt, tbtt


def _state(q, n, k, seed, density=0.25):
    rng = np.random.default_rng(seed)
    adj = rng.uniform(0, 100, (4, n, n)).astype(np.float32)
    adj[rng.random(adj.shape) > density] = -np.inf
    dist = np.full((q, n, n, k), -np.inf, np.float32)
    seedmask = rng.random(dist.shape) < 0.05
    dist[seedmask] = rng.uniform(0, 100, int(seedmask.sum())).astype(np.float32)
    return adj, dist


def test_transition_tables_match():
    jbtt, tbtt = _tables(EXPRS)
    for field in ("qidx", "src", "lab", "dst", "start_mask", "active"):
        np.testing.assert_array_equal(getattr(tbtt, field).numpy(),
                                      np.asarray(getattr(jbtt, field)))
    assert (tbtt.n_queries, tbtt.k, tbtt.n_labels) == \
        (jbtt.n_queries, jbtt.k, jbtt.n_labels)
    np.testing.assert_array_equal(tbtt.start_idx.numpy(),
                                  np.nonzero(np.asarray(jbtt.start_mask))[0])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,seed", [(7, 0), (12, 1)])
def test_batched_closure_matches(n, seed, masked):
    jbtt, tbtt = _tables(EXPRS)
    q, k = len(EXPRS), jbtt.k
    adj, dist = _state(q, n, k, seed)
    mask = np.array([True, False, True, True, False]) if masked else None
    jd, jr, jqr = jsr.batched_closure(
        jnp.asarray(dist), jnp.asarray(adj), jbtt, "jnp",
        query_mask=None if mask is None else jnp.asarray(mask))
    td, tr, tqr = tsr.batched_closure(
        torch.from_numpy(dist.copy()), torch.from_numpy(adj), tbtt, "plain",
        query_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tr == int(jr)
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    if masked:  # masked lanes pass through untouched
        np.testing.assert_array_equal(td.numpy()[~mask], dist[~mask])


def test_one_round_and_valid_pairs_match():
    jbtt, tbtt = _tables(EXPRS)
    q, n, k = len(EXPRS), 9, jbtt.k
    adj, dist = _state(q, n, k, 3, density=0.4)
    mask = np.array([True, True, False, True, True])
    jout = jsr.batched_relax_round(jnp.asarray(dist), jnp.asarray(adj), jbtt,
                                   "jnp", query_mask=jnp.asarray(mask))
    tout = tsr.batched_relax_round(torch.from_numpy(dist), torch.from_numpy(adj),
                                   tbtt, "plain", query_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    finals = np.random.default_rng(4).random((q, k)) < 0.5
    low = np.array([10.0, 20.0, 30.0, 40.0, 50.0], np.float32)
    np.testing.assert_array_equal(
        tsr.batched_valid_pairs(tout, torch.from_numpy(finals),
                                torch.from_numpy(low)).numpy(),
        np.asarray(jsr.batched_valid_pairs(jout, jnp.asarray(finals),
                                           jnp.asarray(low))))


def test_closure_host_syncs_equal_rounds():
    _jbtt, tbtt = _tables(EXPRS)
    adj, dist = _state(len(EXPRS), 8, tbtt.k, 7)
    _d, rounds, _qr, syncs = tsr._closure(
        torch.from_numpy(dist), torch.from_numpy(adj), tbtt, None, 0, None,
        None, None)
    assert syncs == rounds >= 1


def test_backends_agree_and_resolve():
    _jbtt, tbtt = _tables(EXPRS)
    adj, dist = _state(len(EXPRS), 10, tbtt.k, 11)
    a, *_ = tsr.batched_closure(torch.from_numpy(dist.copy()),
                                torch.from_numpy(adj), tbtt, "plain")
    b, *_ = tsr.batched_closure(torch.from_numpy(dist.copy()),
                                torch.from_numpy(adj), tbtt, None)
    assert torch.equal(a, b)
    assert isinstance(resolve_backend(None), KernelBackend)
    assert isinstance(resolve_backend("plain"), PlainBackend)
    assert resolve_backend("cuda") is resolve_backend(None)
    assert KNOWN_BACKENDS[0] == "cuda"
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        resolve_backend("mxu_bucket")
    with pytest.raises(ValueError, match="known backends"):
        resolve_backend("palas")
