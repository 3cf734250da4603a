"""The port's sharded rounds (``repro_torch.core.semiring``:
``shard_transitions``, ``shard_relax_round``, ``shard_closure``,
``shard_frontier_closure``, ``shard_frontier_delete``) against the JAX
package's, called directly, outside ``shard_map``, with ``model_axis=None``,
on the CPU. Tolerance 0: the same dist, rounds, per-lane rounds and
frontier stats. Backends: the port's ``"plain"`` against ``"jnp"``, and
the bucket backend against JAX's (plain versions on both sides).

One lane table of 8 lanes (lane 1 deregistered mid-table, an inert lane)
over 4 shards of 2 lanes; the shard whose mask is all False skips (0
rounds, blocks passed through). Then the model peers: a block split over
two v-column peers on the CPU, whose partials fold with max, equals JAX's
unsharded call on the whole block, and the lockstep loop makes one host
read a round for all shards together.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.automaton import compile_query as jax_compile
from repro.core.backend import BucketBackend as JaxBucket
from repro.core.engine import _INERT_DFA as JAX_INERT
from repro_torch.core import semiring as tsr
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import BucketBackend
from repro_torch.core.engine import _INERT_DFA as PORT_INERT

NEG_INF = float("-inf")
LABELS = ("a", "b", "c")
EXPRS = ["a . b*", None, "(a | b | c)+", "a . b* . c*", "a? . b*", "a . b . c",
         "(a . b)+", "a . b* . c"]   # lane 1: deregistered (inert)
N, Q_CAP, SHARDS, NOW, W_MAX = 8, 8, 4, 50.0, 20.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tables(exprs):
    jbtt = jsr.BatchedTransitionTable.from_dfas(
        [jax_compile(e) if e else JAX_INERT for e in exprs], LABELS)
    tbtt = tsr.BatchedTransitionTable.from_dfas(
        [compile_query(e) if e else PORT_INERT for e in exprs], LABELS,
        device="cpu")
    return jbtt, tbtt


JBTT, TBTT = _tables(EXPRS)
K = TBTT.k
JROWS = jsr.shard_transitions(JBTT, Q_CAP, SHARDS)
TABLES = tsr.shard_tables(TBTT, Q_CAP, SHARDS, device="cpu")
Q_L = Q_CAP // SHARDS
#: the bucket grid of tests/test_torch_bucket_engine.py: 8 levels over the
#: 20 s window, a step of 2.5, exact in float32, so the decode's
#: ``origin + level * step`` rounds alike whether XLA fuses it into a
#: multiply-add inside the reference's compiled branch or not
BACKENDS = {"plain": ("jnp", "plain"),
            "bucket": (JaxBucket(n_levels=8, use_pallas=False),
                       BucketBackend(8, use_kernels=False))}


def _operands(seed, density=0.08):
    """A (Q_L, N, N, K) block with a few finite entries and a 3-label
    adjacency, float32 timestamps in [30, 50) from ``seed``."""
    rng = np.random.default_rng(seed)
    dist = np.full((Q_L, N, N, K), NEG_INF, np.float32)
    hit = rng.random(dist.shape) < density
    dist[hit] = rng.uniform(30.0, 50.0, hit.sum())
    adj = np.full((3, N, N), NEG_INF, np.float32)
    hit = rng.random(adj.shape) < 0.25
    adj[hit] = rng.uniform(30.0, 50.0, hit.sum())
    return dist, adj


def _mask(shard):
    """The shard's live lanes (lane 1 is inert); shard 3 all masked."""
    m = np.array([e is not None for e in EXPRS], bool)[shard * Q_L:(shard + 1) * Q_L]
    return m & (shard != 3)


# the reference's functions under jit, as its mesh executor runs them (inside
# shard_map): one compile per configuration, reused by every shard
J_RELAX = jax.jit(jsr.shard_relax_round, static_argnames=("backend",))
J_CLOSURE = jax.jit(jsr.shard_closure, static_argnames=("backend",))
J_FRONTIER = {delete: jax.jit(fn, static_argnums=(7,), static_argnames=("backend",))
              for delete, fn in ((False, jsr.shard_frontier_closure),
                                 (True, jsr.shard_frontier_delete))}


def _jrows(shard):
    return tuple(r[shard] for r in JROWS)


def _clock():
    return (jnp.float32(NOW), jnp.float32(W_MAX),
            torch.tensor(NOW, dtype=torch.float32),
            torch.tensor(W_MAX, dtype=torch.float32))


@pytest.mark.parametrize("q_cap,n_shards", [(4, 1), (4, 2), (8, 4)])
def test_shard_transitions_match_jax(q_cap, n_shards):
    jbtt, tbtt = _tables(EXPRS[:q_cap])
    j = jsr.shard_transitions(jbtt, q_cap, n_shards)
    t = tsr.shard_transitions(tbtt, q_cap, n_shards, device="cpu")
    for name, a, b in zip(("qidx", "src", "lab", "dst", "start", "active"), t, j):
        assert a.dtype == (torch.bool if name in ("start", "active") else torch.int32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    with pytest.raises(ValueError):
        tsr.shard_transitions(tbtt, q_cap, 3, device="cpu")


def test_shard_relax_round_matches_jax():
    for shard in range(SHARDS):
        dist, adj = _operands(shard)
        mask = _mask(shard)
        jd, jch = J_RELAX(
            jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(adj), *_jrows(shard),
            jnp.asarray(mask), backend="jnp")
        block = torch.from_numpy(dist)
        td, tch = tsr.shard_relax_round(block, torch.from_numpy(adj),
                                        TABLES[shard], mask, backend="plain")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
        assert torch.equal(block, torch.from_numpy(dist))   # inputs untouched


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_shard_closure_matches_jax(backend):
    jb, tb = BACKENDS[backend]
    jnow, jw, tnow, tw = _clock()
    for shard in range(SHARDS):
        dist, adj = _operands(10 + shard)
        mask = _mask(shard)
        jd, jr, jqr = J_CLOSURE(
            jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(adj), _jrows(shard),
            jnp.asarray(mask), backend=jb, now=jnow, w_max=jw)
        td, tr, tqr = tsr.shard_closure(torch.from_numpy(dist.copy()),
                                        torch.from_numpy(adj), TABLES[shard],
                                        mask, backend=tb, now=tnow, w_max=tw)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=str(shard))
        assert tr == int(jr), shard
        np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
        if not mask.any():   # the skip: no round, the block passed through
            assert tr == 0 and not tqr.any()
            np.testing.assert_array_equal(td.numpy(), dist)
        else:
            assert tr >= 2


def _frontier_call(delete, backend, f_cap, shard, seed):
    """One shard's frontier ingest or delete in both packages; returns
    (jax 7-tuple, port 7-tuple)."""
    jb, tb = BACKENDS[backend]
    jnow, jw, tnow, tw = _clock()
    dist, adj = _operands(seed, density=0.05)
    src = np.array([3, 5, 0], np.int32)
    smask = np.array([True, True, False])
    mask = _mask(shard)
    jfn = J_FRONTIER[delete]
    tfn = tsr.shard_frontier_delete if delete else tsr.shard_frontier_closure
    j = jfn(jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(adj), _jrows(shard),
            jnp.asarray(mask), jnp.asarray(src), jnp.asarray(smask), f_cap,
            backend=jb, now=jnow, w_max=jw)
    t = tfn(torch.from_numpy(dist.copy()), torch.from_numpy(adj), TABLES[shard],
            mask, torch.from_numpy(src.astype(np.int64)), torch.from_numpy(smask),
            f_cap, backend=tb, now=tnow, w_max=tw)
    return j, t


@pytest.mark.parametrize("f_cap", [2, 8])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("delete", [False, True], ids=["ingest", "delete"])
def test_shard_frontier_matches_jax(delete, backend, f_cap):
    """f_cap=2 overflows (the shard's own dense fallback), f_cap=8 runs the
    frontier rounds; shard 3 (all masked) skips."""
    fell = set()
    for shard in range(SHARDS):
        j, t = _frontier_call(delete, backend, f_cap, shard, 20 + shard)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]), err_msg=str(shard))
        assert t[1] == int(j[1]), shard
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        # rows_relaxed, fell_back, seed_rows, max_lane_rows
        assert (t[3], t[4], t[5], t[6]) == \
            (int(j[3]), bool(j[4]), int(j[5]), int(j[6])), shard
        fell.add(t[4])
        if shard == 3:
            assert t[1] == 0 and t[5] == 0
    assert fell == ({True, False} if f_cap == 2 else {False})


@pytest.mark.parametrize("which", ["closure", "ingest", "delete"])
def test_model_peers_fold_exactly(which):
    """Two v-column peers of one lane shard (each contracts its own u
    block; the partials fold with max) equal JAX's unsharded call on the
    whole block and the port's single peer."""
    shard = 2
    dist, adj = _operands(30, density=0.05)
    mask = _mask(shard)
    src, smask = np.array([3, 6, 1], np.int64), np.array([True, True, True])
    jnow, jw, tnow, tw = _clock()

    def port(blocks):
        a = torch.from_numpy(adj)
        if which == "closure":
            return tsr.shard_closure(blocks, a, TABLES[shard], mask, "plain")
        fn = tsr.shard_frontier_delete if which == "delete" else tsr.shard_frontier_closure
        return fn(blocks, a, TABLES[shard], mask, torch.from_numpy(src),
                  torch.from_numpy(smask), 4, "plain")

    one = port(torch.from_numpy(dist.copy()))
    peers = port([torch.from_numpy(dist[:, :, :N // 2].copy()),
                  torch.from_numpy(dist[:, :, N // 2:].copy())])
    joined = torch.cat(peers[0], dim=2)
    if which == "closure":
        j = J_CLOSURE(jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(adj),
                              _jrows(shard), jnp.asarray(mask), backend="jnp",
                              now=jnow, w_max=jw)
    else:
        j = J_FRONTIER[which == "delete"](jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(adj), _jrows(shard),
               jnp.asarray(mask), jnp.asarray(src.astype(np.int32)),
               jnp.asarray(smask), 4, backend="jnp", now=jnow, w_max=jw)
    np.testing.assert_array_equal(joined.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(j[0]))
    assert peers[1] == one[1] == int(j[1]) >= 1
    np.testing.assert_array_equal(peers[2].numpy(), np.asarray(j[2]))
    assert tuple(peers[3:]) == tuple(one[3:])


def test_lockstep_reads_once_per_round():
    """All four shards of a dispatch: per-shard rounds as their own calls
    give them, and one host read a round for all shards together: as many
    reads as the slowest shard's rounds."""
    blocks, adj = [], None
    for shard in range(SHARDS):
        dist, adj = _operands(40 + shard)
        blocks.append(dist)
    a = torch.from_numpy(adj)
    alone = [tsr.shard_closure(torch.from_numpy(b.copy()), a, TABLES[s], _mask(s),
                               "plain") for s, b in enumerate(blocks)]
    shards = [tsr.Shard([torch.from_numpy(b.copy())], [a], [a], [TABLES[s]],
                        torch.from_numpy(_mask(s)), _mask(s))
              for s, b in enumerate(blocks)]
    out, reads = tsr.shards_closure(shards, "plain")
    for (res, rounds, qr), (d1, r1, qr1) in zip(out, alone):
        assert rounds == r1
        assert torch.equal(res[0], d1) and torch.equal(qr, qr1)
    assert reads == max(r for _d, r, _q in alone)
    assert sorted(r for _d, r, _q in alone)[0] == 0   # the masked shard
