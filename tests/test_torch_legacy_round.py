"""The legacy single-query round in the port against the JAX package:
``TransitionTable.from_dfa`` (the empty language included), ``relax_round``,
``closure`` (dist and rounds) and ``valid_pairs``, for the plain, the
"cuda" (its plain versions on the CPU) and the bucket backends, on
tests/test_distributed_relax.py's cases: the float round, and the level
round at T=8. Also the single-pair kernel B2's plain version against the
Pallas kernel in interpret mode, and ``DenseRPQEngine.tt``. Tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.automaton import DFA as JaxDFA
from repro.core.automaton import compile_query as jax_compile
from repro.core.backend import BucketBackend as JaxBucket
from repro.core.engine import DenseRPQEngine as JaxDense
from repro.core.semiring import TransitionTable as JaxTT
from repro.core.semiring import closure as jax_closure
from repro.core.semiring import relax_round as jax_relax
from repro.core.semiring import valid_pairs as jax_valid
from repro.kernels.maxmin.maxmin import maxmin_matmul as jax_b2
from repro_torch.core.automaton import DFA, compile_query
from repro_torch.core.contraction import BucketBackend
from repro_torch.core.engine import DenseRPQEngine
from repro_torch.core.semiring import (
    TransitionTable,
    _single_closure,
    closure,
    relax_round,
    valid_pairs,
)
from repro_torch.kernels.maxmin import maxmin as b1
from repro_torch.kernels.maxmin.ref import maxmin_matmul_naive, maxmin_matmul_ref

EXPRS = ["a . b*", "(a | b)*", "a . b* . c", "a?"]
N = 24
T = 8
FLOAT_BACKENDS = ["plain", "cuda"]


def _tables(expr):
    return (JaxTT.from_dfa(jax_compile(expr)),
            TransitionTable.from_dfa(compile_query(expr), device="cpu"))


def _case(dfa, seed, n=N):
    """tests/test_distributed_relax.py's operands at size n: dist and adj
    uniform on [0, 100) with half of dist and 60% of adj -inf, and their
    levels on a grid of step 100/T."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 100, (n, n, dfa.k)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.5] = -np.inf
    adj = rng.uniform(0, 100, (dfa.n_labels, n, n)).astype(np.float32)
    adj[rng.random(adj.shape) < 0.6] = -np.inf

    def lv(x):
        return np.where(np.isfinite(x), np.clip(np.ceil(x / (100.0 / T)), 0, T),
                        0).astype(np.int32)

    return dist, adj, lv(dist), lv(adj)


def _tt_fields(tt):
    return [np.asarray(x) for x in (tt.src, tt.lab, tt.dst, tt.dst_onehot,
                                    tt.start_mask)] + [tt.k, tt.n_labels]


def _empty_language(dfa_cls):
    return dfa_cls(labels=("a", "b"), delta=np.full((2, 2), -1, np.int32),
                   start=0, finals=frozenset())


def test_transition_table_from_dfa_matches_reference():
    for expr in EXPRS + ["(a | b | c)+", "a . b . c*"]:
        jt, tt = _tables(expr)
        for a, b in zip(_tt_fields(tt), _tt_fields(jt)):
            np.testing.assert_array_equal(a, b, err_msg=expr)
        assert tt.src.dtype == torch.int64 and tt.start_mask.dtype == torch.bool
    # the empty language: one inert row that never fires
    jt = JaxTT.from_dfa(_empty_language(JaxDFA))
    tt = TransitionTable.from_dfa(_empty_language(DFA), device="cpu")
    for a, b in zip(_tt_fields(tt), _tt_fields(jt)):
        np.testing.assert_array_equal(a, b)
    d = torch.full((5, 5, 2), float("-inf"))
    adj = torch.rand((2, 5, 5))
    assert torch.equal(relax_round(d, adj, tt, "plain"), d)
    out, rounds = closure(d, adj, tt, "plain")
    assert torch.equal(out, d) and rounds == 2


@pytest.mark.parametrize("backend", FLOAT_BACKENDS)
@pytest.mark.parametrize("expr", EXPRS)
def test_float_round_closure_and_valid_pairs(expr, backend):
    jt, tt = _tables(expr)
    dist, adj, _, _ = _case(jax_compile(expr), seed=len(expr))
    ref = np.asarray(jax_relax(jnp.asarray(dist), jnp.asarray(adj), jt))
    td, ta = torch.from_numpy(dist), torch.from_numpy(adj)
    out = relax_round(td, ta, tt, backend)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(td, torch.from_numpy(dist))       # the input is kept
    for d0 in (dist, np.full_like(dist, -np.inf)):
        jd, jr = jax_closure(jnp.asarray(d0), jnp.asarray(adj), jt)
        before = b1.maxmin_matmul.launches
        od, rounds, syncs = _single_closure(torch.from_numpy(d0), ta, tt,
                                            backend, 0)
        np.testing.assert_array_equal(od.numpy(), np.asarray(jd))
        assert rounds == int(jr) and syncs == rounds - 1
        assert b1.maxmin_matmul.launches == before     # CPU: no launch
        finals = np.zeros(tt.k, bool)
        finals[sorted(compile_query(expr).finals)] = True
        for low in (-np.inf, 40.0, 99.0):
            jv = np.asarray(jax_valid(jd, jnp.asarray(finals), jnp.float32(low)))
            tv = valid_pairs(od, torch.from_numpy(finals), torch.tensor(low))
            np.testing.assert_array_equal(tv.numpy(), jv)
    # a capped closure stops at its bound, as the reference's does
    jd, jr = jax_closure(jnp.asarray(dist), jnp.asarray(adj), jt, max_rounds=2)
    od, rounds = closure(td, ta, tt, backend, max_rounds=2)
    np.testing.assert_array_equal(od.numpy(), np.asarray(jd))
    assert rounds == int(jr) == 2


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("expr", EXPRS)
def test_level_round_and_closure_at_t8(expr, use_kernels):
    """The level round through ``BucketBackend.contract`` (B4's plain
    version on the CPU) equals the reference's ``relax_round`` with its
    bucket backend, and both equal the float round on levels."""
    jt, tt = _tables(expr)
    dist, adj, dist_lv, adj_lv = _case(jax_compile(expr), seed=3 + len(expr))
    jb = JaxBucket(n_levels=T, use_pallas=False)
    tb = BucketBackend(n_levels=T, use_kernels=use_kernels)
    ref = np.asarray(jax_relax(jnp.asarray(dist_lv), jnp.asarray(adj_lv), jt, jb))
    out = relax_round(torch.from_numpy(dist_lv), torch.from_numpy(adj_lv), tt, tb)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # the float round on levels (test_distributed_relax's mxu check)
    as_f = np.where(adj_lv > 0, adj_lv, -np.inf).astype(np.float32)
    ref_f = np.asarray(jax_relax(jnp.asarray(dist_lv.astype(np.float32)),
                                 jnp.asarray(as_f), jt))
    np.testing.assert_array_equal(
        out.numpy(), np.where(np.isfinite(ref_f), ref_f, 0).astype(np.int32))
    jd, jr = jax_closure(jnp.asarray(dist_lv), jnp.asarray(adj_lv), jt, jb)
    od, rounds = closure(torch.from_numpy(dist_lv), torch.from_numpy(adj_lv), tt, tb)
    np.testing.assert_array_equal(od.numpy(), np.asarray(jd))
    assert rounds == int(jr)


def test_bucket_closure_is_the_grid_mapped_float_closure():
    """Encode, the level closure, decode: equal to the float closure mapped
    through the grid (the level closure commutes with the grid map)."""
    dfa = compile_query("a . b* . c")
    tt = TransitionTable.from_dfa(dfa, device="cpu")
    dist, adj, _, _ = _case(dfa, seed=9)
    dist[:] = -np.inf
    td, ta = torch.from_numpy(dist), torch.from_numpy(adj)
    tb = BucketBackend(n_levels=T)
    now, w = torch.tensor(100.0), torch.tensor(80.0)
    d_l, a_l = tb.prepare_state(td, ta, now, w)
    dec = tb.decode_state(closure(d_l, a_l, tt, tb)[0], now, w)
    d_f = closure(td, ta, tt, "plain")[0]
    step = w / T
    origin = torch.floor((now - w) / step) * step
    fin = torch.isfinite(dec)
    assert torch.equal(dec[fin], (torch.ceil(d_f / step) * step)[fin])
    assert bool((d_f[~fin] <= origin + 1e-4).all())
    assert int(fin.sum()) > 0


# tests/test_kernels.py: SHAPES (m, k, n)
SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 200), (1, 256, 33),
          (257, 1, 129), (64, 512, 64)]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_b2_matches_pallas_kernel(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.uniform(0, 1000, (m, k)).astype(dtype)
    b = rng.uniform(0, 1000, (k, n)).astype(dtype)
    a[rng.random(a.shape) > 0.7] = -np.inf
    b[rng.random(b.shape) > 0.7] = -np.inf
    ref = np.asarray(jax_b2(jnp.asarray(a), jnp.asarray(b), interpret=True))
    ta, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    out = maxmin_matmul_ref(ta, tb_)
    assert out.dtype == ta.dtype
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(maxmin_matmul_naive(ta, tb_), out)
    before = b1.maxmin_matmul.launches
    assert torch.equal(b1.maxmin_matmul(ta, tb_), out)
    assert b1.maxmin_matmul.launches == before
    with pytest.raises(ValueError):
        b1.maxmin_matmul(ta, torch.zeros((k + 1, n), dtype=ta.dtype))


def test_dense_engine_exposes_the_legacy_table():
    """``DenseRPQEngine.tt`` is the reference's table, on the engine's
    device; the legacy closure over the engine's adjacency gives the
    engine's valid pairs."""
    expr = "a2q . c2a*"
    jd = JaxDense(jax_compile(expr), 20.0, n_slots=8, batch_size=1, backend="jnp")
    td = DenseRPQEngine(compile_query(expr), 20.0, n_slots=8, batch_size=1,
                        device="cpu")
    for a, b in zip(_tt_fields(td.tt), _tt_fields(jd.tt)):
        np.testing.assert_array_equal(a, b)
    assert td.tt.src.device == td.device
    edges = [(0, 1, "a2q", 1.0), (1, 2, "c2a", 2.0), (2, 3, "c2a", 3.0),
             (4, 0, "a2q", 4.0)]
    for e in edges:
        assert td.insert(*e) == jd.insert(*e)
    arr = td.arrays
    dist0 = torch.full_like(arr.dist, float("-inf"))
    out, _ = closure(dist0, arr.adj, td.tt, td.backend)
    finals = torch.zeros(td.tt.k, dtype=torch.bool)
    finals[sorted(td.dfa.finals)] = True
    valid = valid_pairs(out, finals, arr.now - 20.0)
    slot = {v: s for v, s in td.slot_of.items()}
    got = {(x, y) for x in slot for y in slot if bool(valid[slot[x], slot[y]])}
    assert got == td.current_results() == jd.current_results()
