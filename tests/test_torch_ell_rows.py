"""Kernel B5's whole contraction in the port — the gather-contract on the
ELL rows of each transition row's label with the spill ring folded in —
and the dense ELL round chunked over J, against the JAX package.

``ell_contract_rows_ref`` (and the backends' ``contract_rows_ell`` and
the wrapper, which on the CPU take it) equals the JAX package's
``JnpBackend`` and ``PallasBackend`` (interpret mode) ``contract_rows_ell``
on float32 timestamps and its ``BucketBackend`` on int32 levels; the
J-chunked dense ELL round equals the unchunked one and the JAX
``batched_relax_round``. The same numpy inputs, made from a seed, go
through both packages. Max and min never reassociate, so the tolerance is
0 (``assert_array_equal``). The CUDA kernel is held against the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.automaton import compile_query as jax_compile
from repro.core.backend import BucketBackend as JaxBucket
from repro.core.backend import JnpBackend, PallasBackend
from repro.core.sparse_adj import EllAdjacency as JaxEll
from repro_torch.core import semiring as tsr
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import BucketBackend, PlainBackend, resolve_backend
from repro_torch.core.sparse_adj import from_numpy as ell_from_numpy
from repro_torch.kernels.ell import ell as b5
from repro_torch.kernels.ell.ref import ell_contract_rows_ref

# (J, M, U, E) and the ring's variant; the shapes repeat so the JAX
# compiles are shared. 37 and 131 are no multiple of any tile.
CASES = {
    "live_ring": (5, 6, 37, 2, "live"),
    "repeated_labels": (5, 6, 37, 2, "repeated"),
    "label_absent_from_ring": (5, 6, 37, 2, "absent"),
    "out_of_range_dst": (5, 6, 37, 2, "out_of_range"),
    "e1": (5, 6, 37, 1, "live"),
    "m1": (5, 1, 37, 2, "live"),
    "ragged_u": (5, 6, 131, 2, "live"),
}
N_LABELS, RING = 3, 8


def _leaves(rng, u, e, variant):
    """ELL leaves (L, U, E) and a ring of RING entries, most of them live,
    one a ring copy of a row-resident edge; numpy, the JAX dtypes."""
    idx = rng.integers(0, u, (N_LABELS, u, e)).astype(np.int32)
    ts = np.where(rng.random((N_LABELS, u, e)) < 0.6,
                  rng.integers(1, 40, (N_LABELS, u, e)), -np.inf).astype(np.float32)
    src = rng.integers(0, u, (RING,))
    dst = rng.integers(0, u, (RING,))
    lab = rng.integers(0, N_LABELS, (RING,))
    sts = np.where(rng.random(RING) < 0.8, rng.integers(1, 40, (RING,)),
                   -np.inf).astype(np.float32)
    src[0], dst[0], lab[0] = 0, idx[0, 0, 0], 0      # a ring copy of a row edge
    if variant == "absent":
        lab = lab % 2                                # label 2 has no ring entry
    if variant == "out_of_range":
        dst[1], dst[2] = u, u + 5                    # dropped, as JAX's scatter
        sts[1] = sts[2] = 30.0
    return (idx, ts, src.astype(np.int32), dst.astype(np.int32),
            lab.astype(np.int32), sts, np.int32(RING - 1))


def _operands(j, m, u, e, variant, seed=0):
    rng = np.random.default_rng(seed + 1000 * j + 100 * m + u + e)
    leaves = _leaves(rng, u, e, variant)
    d = np.where(rng.random((j, m, u)) < 0.5, rng.integers(1, 40, (j, m, u)),
                 -np.inf).astype(np.float32)
    labs = {"repeated": np.full(j, 2), "absent": np.arange(j) % 3}.get(
        variant, rng.integers(0, N_LABELS, (j,)))
    return d, leaves, labs.astype(np.int32)


def _levels(x):
    """float32 timestamps -> int32 levels 1..10 (-inf -> level 0)."""
    out = np.zeros(np.shape(x), np.int32)
    fin = np.isfinite(x)
    out[fin] = x[fin] // 4 + 1
    return out


def _jax(d, leaves, labs, backend):
    ell = JaxEll(*[jnp.asarray(x) for x in leaves])
    return np.asarray(backend.contract_rows_ell(jnp.asarray(d), ell, jnp.asarray(labs)))


def _port_outputs(d, leaves, labs, zero, backends):
    """The plain version, the wrapper (on the CPU: the plain version, no
    launch) and each backend's contract_rows_ell, on torch copies."""
    td, tl = torch.from_numpy(d), torch.from_numpy(labs)
    ell = ell_from_numpy(JaxEll(*leaves), "cpu")
    ring = (ell.spill_src, ell.spill_dst, ell.spill_lab, ell.spill_ts)
    before = b5.ell_contract_rows.launches
    outs = {"ref": ell_contract_rows_ref(td, ell.idx, ell.ts, tl, *ring, zero=zero),
            "ref_labs_int64": ell_contract_rows_ref(td, ell.idx, ell.ts, tl.long(),
                                                    *ring, zero=zero),
            "wrapper": b5.ell_contract_rows(td, ell.idx, ell.ts, tl, *ring)}
    assert b5.ell_contract_rows.launches == before
    for name, backend in backends.items():
        outs[name] = backend.contract_rows_ell(td, ell, tl.long())
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_contract_rows_ell_ref_matches_jax_backends(case):
    j, m, u, e, variant = CASES[case]
    d, leaves, labs = _operands(j, m, u, e, variant)
    ref = _jax(d, leaves, labs, JnpBackend())
    np.testing.assert_array_equal(
        _jax(d, leaves, labs, PallasBackend(interpret=True)), ref)
    outs = _port_outputs(d, leaves, labs, float("-inf"),
                         {"plain": resolve_backend("plain"),
                          "cuda": resolve_backend("cuda")})
    for name, out in outs.items():
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=name)


@pytest.mark.parametrize("case", ["live_ring", "label_absent_from_ring",
                                  "out_of_range_dst", "ragged_u"])
def test_contract_rows_ell_on_levels_matches_jax_bucket(case):
    j, m, u, e, variant = CASES[case]
    d, leaves, labs = _operands(j, m, u, e, variant, seed=7)
    d = _levels(d)
    leaves = (leaves[0], _levels(leaves[1]), *leaves[2:5], _levels(leaves[5]),
              leaves[6])
    ref = _jax(d, leaves, labs, JaxBucket(8, use_pallas=False))
    outs = _port_outputs(d, leaves, labs, 0,
                         {"bucket": BucketBackend(8),
                          "bucket_plain": BucketBackend(8, use_kernels=False)})
    for name, out in outs.items():
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=name)


def test_wrapper_rejects_mismatched_operands():
    d, leaves, labs = _operands(5, 6, 37, 2, "live")
    ell = ell_from_numpy(JaxEll(*leaves), "cpu")
    td, tl = torch.from_numpy(d), torch.from_numpy(labs)
    ring = [ell.spill_src, ell.spill_dst, ell.spill_lab, ell.spill_ts]
    with pytest.raises(ValueError, match="shape mismatch"):
        b5.ell_contract_rows(td[:, :, :30], ell.idx, ell.ts, tl, *ring)
    with pytest.raises(ValueError, match="shape mismatch"):
        b5.ell_contract_rows(td, ell.idx, ell.ts, tl[:4], *ring)
    with pytest.raises(ValueError, match="shape mismatch"):
        b5.ell_contract_rows(td, ell.idx, ell.ts, tl, *ring[:3], ring[3][:5])
    with pytest.raises(ValueError, match="3-D"):
        b5.ell_contract_rows(td[0], ell.idx, ell.ts, tl, *ring)


# -- the dense ELL round, chunked over J ---------------------------------------

EXPRS = ["a . b*", "(a | b | c)+", "a . b* . c*", "a? . b*", "a . b . c"]
LABELS = ("a", "b", "c")


class _Counting(PlainBackend):
    """The plain backend, counting its ELL contractions."""

    calls = 0

    def contract_rows_ell(self, d_s, ell, labs):
        type(self).calls += 1
        return super().contract_rows_ell(d_s, ell, labs)


def _round_state(n, seed):
    jbtt = jsr.BatchedTransitionTable.from_dfas([jax_compile(x) for x in EXPRS],
                                                LABELS)
    tbtt = tsr.BatchedTransitionTable.from_dfas([compile_query(x) for x in EXPRS],
                                                LABELS, device="cpu")
    rng = np.random.default_rng(seed)
    leaves = _leaves(rng, n, 2, "live")
    dist = np.full((len(EXPRS), n, n, jbtt.k), -np.inf, np.float32)
    live = rng.random(dist.shape) < 0.1
    dist[live] = rng.integers(1, 40, int(live.sum()))
    return jbtt, tbtt, leaves, dist


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, "J"])
def test_chunked_dense_ell_round_matches_unchunked_and_jax(monkeypatch, chunk,
                                                           masked):
    n = 9
    jbtt, tbtt, leaves, dist = _round_state(n, seed=11)
    j_rows = tbtt.qidx.shape[0]
    rows = j_rows if chunk == "J" else chunk
    mask = np.array([True, False, True, True, True]) if masked else None
    ref = np.asarray(jsr.batched_relax_round(
        jnp.asarray(dist), JaxEll(*[jnp.asarray(x) for x in leaves]), jbtt, "jnp",
        query_mask=None if mask is None else jnp.asarray(mask)))
    ell = ell_from_numpy(JaxEll(*leaves), "cpu")
    qmask = None if mask is None else torch.from_numpy(mask)
    whole = tsr.batched_relax_round(torch.from_numpy(dist), ell, tbtt, "plain",
                                    query_mask=qmask)
    # a byte budget that holds exactly `rows` transition rows a chunk
    monkeypatch.setattr(tsr, "ELL_ROUND_BYTES", rows * 2 * n * n * 4)
    assert tsr.ell_round_chunk(j_rows, n) == rows
    _Counting.calls = 0
    out = tsr.batched_relax_round(torch.from_numpy(dist), ell, tbtt, _Counting(),
                                  query_mask=qmask)
    assert _Counting.calls == tsr.ell_round_launches(j_rows, n) == -(-j_rows // rows)
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_dense_ell_round_on_levels_matches_jax_bucket(monkeypatch, chunk):
    n = 9
    jbtt, tbtt, leaves, dist = _round_state(n, seed=12)
    dist = _levels(dist)
    leaves = (leaves[0], _levels(leaves[1]), *leaves[2:5], _levels(leaves[5]),
              leaves[6])
    ref = np.asarray(jsr.batched_relax_round(
        jnp.asarray(dist), JaxEll(*[jnp.asarray(x) for x in leaves]), jbtt,
        JaxBucket(8, use_pallas=False)))
    monkeypatch.setattr(tsr, "ELL_ROUND_BYTES", chunk * 2 * n * n * 4)
    out = tsr.batched_relax_round(torch.from_numpy(dist),
                                  ell_from_numpy(JaxEll(*leaves), "cpu"), tbtt,
                                  BucketBackend(8))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_round_chunk_from_the_byte_budget():
    # ~2 GiB: 4 transition rows a chunk at N=8192, one chunk at small N
    assert tsr.ell_round_chunk(40, 8192) == 4
    assert tsr.ell_round_launches(40, 8192) == 10
    assert tsr.ell_round_chunk(40, 2048) == 40
    assert tsr.ell_round_launches(40, 2048) == 1
    assert tsr.ell_round_chunk(3, 1 << 20) == 1      # at least one row


@pytest.mark.parametrize("dist_layout", ["dense", "row_sparse"])
def test_executor_counts_every_ell_contraction(monkeypatch, dist_layout):
    """The executor's ``ell_contractions_total`` (what chip_smoke.py and the
    card tests hold B5's launches to) counts every contraction the rounds
    make: one per frontier round, one per J chunk of a dense round (the
    fallbacks and cone-overflow deletes, here 3 transition rows a chunk)."""
    from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
    from repro_torch.streaming.generators import so_like, with_deletions

    monkeypatch.setattr(tsr, "ELL_ROUND_BYTES", 3 * 2 * 16 * 16 * 4)
    queries = [("q1", "a2q . c2a*"), ("q2", "(a2q | c2a | c2q)+")]
    eng = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, "arbitrary") for n, e in queries],
        n_slots=16, batch_size=1, frontier="auto", frontier_cap=2, adj_layout="ell",
        ell_cap=2, dist_layout=dist_layout, dist_cap=2, backend=_Counting(),
        device="cpu")
    ex = eng.executor
    calls0, counted0, rounds0 = _Counting.calls, ex.ell_contractions_total, eng.total_rounds
    nxt = 2.0
    for sgt in with_deletions(so_like(n_vertices=24, n_edges=40, seed=4),
                              ratio=0.05, seed=2):
        if sgt.ts >= nxt:
            eng.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        (eng.insert if sgt.op == "+" else eng.delete)(*sgt.as_edge())
    calls = _Counting.calls - calls0
    assert ex.frontier_stats["fallbacks"] >= 1
    assert calls == ex.ell_contractions_total - counted0 > eng.total_rounds - rounds0
