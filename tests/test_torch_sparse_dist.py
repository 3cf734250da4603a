"""The port's row-sparse dist against the JAX package's, leaf for leaf.

Every ``rsd_*`` function and ``pack_rows`` on the same seeded numpy inputs
through both packages: the overflow table's claim order, its ``lost`` leg,
shrinking rows, padding slots, the drain's re-pack; kernel B6's plain
versions against the Pallas kernel in interpret mode and the one-hot
oracle on the edge cases (duplicate stale keys, all-free rows, C=1, E not
a multiple of the tile); the row-sparse frontier closure and cone delete
on both branches (frontier and dense fallback); and the service's
``dist_log``. Tolerance 0 everywhere: max and min never reassociate.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as jsr
from repro.core import sparse_dist as jsd
from repro.core.automaton import compile_query as jax_compile
from repro.core.sparse_adj import pack_ell as jax_pack_ell
from repro.kernels.rowsparse import (rowsparse_gather_fused,
                                     rowsparse_gather_naive as jax_naive)
from repro.streaming.service import PersistentQueryService as JaxService
from repro_torch.core import semiring as tsr
from repro_torch.core import sparse_dist as tsd
from repro_torch.core.automaton import compile_query
from repro_torch.core.sparse_adj import from_numpy as ell_from_numpy
from repro_torch.core.sparse_adj import pack_ell
from repro_torch.kernels.rowsparse import rowsparse as b6
from repro_torch.kernels.rowsparse.ref import (rowsparse_gather_naive,
                                               rowsparse_gather_ref)
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import Stream
from _torch_pairs import one_torch_thread  # noqa: F401

NEG_INF = float("-inf")
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _dense(rng, q=2, n=10, k=3, density=0.25):
    d = np.full((q, n, n, k), NEG_INF, np.float32)
    hit = rng.random(d.shape) < density
    d[hit] = rng.integers(1, 50, hit.sum()).astype(np.float32)
    return d


def _pair(sd_np):
    """(JAX leaves, port leaves) of one numpy RowSparseDist."""
    return (jax.tree_util.tree_map(jnp.asarray, jsd.RowSparseDist(*sd_np)),
            tsd.from_numpy(tsd.RowSparseDist(*[np.array(x) for x in sd_np]),
                           "cpu"))


def _assert_leaves(t, j, tag=""):
    for name, a, b in zip(t._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} {tag}")


# -- pack, densify, re-pack ---------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_pack_densify_and_repack(seed):
    """pack_rows (numpy), rsd_to_dense, rsd_from_dense (with and without a
    carried ``lost``), rsd_row_counts, rsd_live_entries, rsd_empty_like."""
    rng = np.random.default_rng(seed)
    dense = _dense(rng, density=0.35)
    counts = (dense > NEG_INF).reshape(2, 10, -1).sum(-1)
    for cap, ovf in ((1, 64), (2, 64), (8, 64), (1, 4), (2, 3)):
        if (counts > cap).sum() <= ovf:
            t_np = tsd.pack_rows(dense, cap, ovf)
            j_np = jsd.pack_rows(dense, cap, ovf)
            for a, b in zip(t_np, j_np):
                np.testing.assert_array_equal(a, b)
            jsd_, tsd_ = _pair(j_np)
            np.testing.assert_array_equal(tsd.rsd_to_dense(tsd_).numpy(), dense)
            np.testing.assert_array_equal(
                tsd.rsd_row_counts(tsd_).numpy(),
                np.asarray(jsd.rsd_row_counts(jsd_)))
            assert int(tsd.rsd_live_entries(tsd_)) == \
                int(jsd.rsd_live_entries(jsd_)) == int((dense > NEG_INF).sum())
            _assert_leaves(tsd.rsd_empty_like(tsd_), jsd.rsd_empty_like(jsd_))
        else:
            with pytest.raises(ValueError):
                tsd.pack_rows(dense, cap, ovf)
        # the in-dispatch re-pack: rows past the table are counted as lost
        lost = np.int32(3)
        for base in (None, lost):
            t_out = tsd.rsd_from_dense(
                torch.from_numpy(dense), cap, ovf,
                None if base is None else torch.tensor(base))
            j_out = jsd.rsd_from_dense(
                jnp.asarray(dense), cap, ovf,
                None if base is None else jnp.asarray(base))
            _assert_leaves(t_out, j_out, (cap, ovf, base))
    assert int(t_out.lost) > 3          # the last case drops rows


@pytest.mark.parametrize("seed", range(2))
def test_grow_repack_and_clears(seed):
    """The drain's re-pack (growing, and into a table too small for the
    rows left: they drop, as in the reference), then the slot and lane
    clears on the result."""
    rng = np.random.default_rng(10 + seed)
    dense = _dense(rng, q=3, n=9, k=2, density=0.4)
    jd, td = _pair(jsd.pack_rows(dense, 1, 64))
    assert int(td.ovf_ptr) > 0
    for cap, ovf in ((4, 64), (2, 8), (32, 64)):
        _assert_leaves(tsd.rsd_grow_repack(td, cap, ovf),
                       jsd.rsd_grow_repack(jd, cap, ovf), (cap, ovf))
    jd, td = jsd.rsd_grow_repack(jd, 4, 64), tsd.rsd_grow_repack(td, 4, 64)
    dead = np.zeros(9, bool)
    dead[[1, 4]] = True
    jd = jsd.rsd_clear_slots(jd, jnp.asarray(dead))
    td = tsd.rsd_clear_slots(td, torch.from_numpy(dead))
    _assert_leaves(td, jd, "clear_slots")
    jd = jsd.rsd_clear_lane(jd, jnp.asarray(1, jnp.int32))
    td = tsd.rsd_clear_lane(td, 1)
    _assert_leaves(td, jd, "clear_lane")


@pytest.mark.parametrize("seed", range(3))
def test_gather_and_scatter_rows(seed):
    """Gather (slots and table) and the full-row scatter: existing table
    rows, fitting rows that shrink, rows newly overflowing (claims in row
    order), claims past the table's end (``lost``), and padding slots that
    repeat row 0 of their lane."""
    rng = np.random.default_rng(20 + seed)
    q, n, k, f = 2, 10, 3, 4
    dense = _dense(rng, q, n, k, density=0.3)
    ovf = 1 if seed == 2 else 64
    jd, td = _pair(jsd.pack_rows(dense, 4, 64))
    jd = jsd.rsd_grow_repack(jd, 4, ovf)   # same slots, maybe a 1-row table
    td = tsd.rsd_grow_repack(td, 4, ovf)
    rows = np.array([[0, 3, 5, 0], [0, 2, 5, 9]], np.int64)
    rowmask = np.array([[True, True, True, False], [True] * 4])
    j_slab = jsd.rsd_gather_rows(jd, jnp.asarray(rows, jnp.int32))
    for fn in (b6.rowsparse_gather, rowsparse_gather_ref):
        t_slab = tsd.rsd_gather_rows(td, torch.from_numpy(rows), fn)
        np.testing.assert_array_equal(t_slab.numpy(), np.asarray(j_slab))
    if ovf > 1:   # (a 1-row table dropped the other rows at the re-pack)
        np.testing.assert_array_equal(t_slab.numpy(),
                                      dense[np.arange(q)[:, None], rows])
    # grow some rows past dist_cap, shrink others to a single entry
    new = np.asarray(j_slab).copy()
    new[0, 0] = np.where(rng.random((n, k)) < 0.8, 60.0, NEG_INF)
    new[1, 1] = NEG_INF
    new[1, 1, 3, 0] = 7.0
    new[1, 3] = np.where(rng.random((n, k)) < 0.9, 61.0, NEG_INF)
    jd2 = jsd.rsd_scatter_rows(jd, jnp.asarray(rows, jnp.int32),
                               jnp.asarray(rowmask), jnp.asarray(new))
    td2 = tsd.rsd_scatter_rows(td, torch.from_numpy(rows),
                               torch.from_numpy(rowmask), torch.from_numpy(new))
    _assert_leaves(td2, jd2)
    if seed == 2:
        assert int(td2.lost) > 0


def test_seed_and_valid_pairs():
    """The seed walks stored entries (equal to the dense scan) and the
    sparse emit equals the dense emit, through the semiring's dispatch."""
    rng = np.random.default_rng(1)
    q, n, k = 3, 9, 4
    dense = _dense(rng, q, n, k, density=0.25)
    jd, td = _pair(jsd.pack_rows(dense, 2, 256))
    src = np.array([3, 0, 7, 5, 2])
    smask = np.array([True, True, False, True, False])
    qmask = np.array([True, False, True])
    got = tsd.rsd_seed_gathered(td, torch.from_numpy(src),
                                torch.from_numpy(smask), torch.from_numpy(qmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsd.rsd_seed_gathered(
        jd, jnp.asarray(src), jnp.asarray(smask), jnp.asarray(qmask))))
    np.testing.assert_array_equal(got.numpy(), tsr.frontier_seed(
        torch.from_numpy(dense), torch.from_numpy(src), torch.from_numpy(smask),
        torch.from_numpy(qmask)).numpy())
    finals = np.random.default_rng(0).random((q, k)) < 0.5
    low = np.array([3.0, 10.0, 25.0], np.float32)
    got = tsr.batched_valid_pairs(td, torch.from_numpy(finals),
                                  torch.from_numpy(low))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsd.rsd_valid_pairs(
        jd, jnp.asarray(finals), jnp.asarray(low))))
    np.testing.assert_array_equal(got.numpy(), tsr.batched_valid_pairs(
        torch.from_numpy(dense), torch.from_numpy(finals),
        torch.from_numpy(low)).numpy())


# -- kernel B6's plain versions ------------------------------------------------

B6_CASES = [  # (M, C, E, what)
    (12, 4, 30, "random"), (5, 1, 33, "C=1"), (9, 16, 257, "duplicates"),
    (7, 8, 40, "all free rows"), (3, 64, 100, "wide rows")]


def b6_operands(rng, m, c, e, what):
    """Seeded (idx int32, ts f32) slot rows: a quarter of the slots free
    (ts -inf) with stale keys, plus the case's edge."""
    idx = rng.integers(0, e, (m, c)).astype(np.int32)
    ts = rng.integers(1, 40, (m, c)).astype(np.float32)
    ts[rng.random((m, c)) < 0.25] = NEG_INF
    if what == "duplicates":
        idx[:, 1::2] = idx[:, ::2][:, : idx[:, 1::2].shape[1]]
    if what == "all free rows":
        ts[::2] = NEG_INF
    return idx, ts


@pytest.mark.parametrize("m,c,e,what", B6_CASES)
def test_b6_plain_versions_match_reference(m, c, e, what):
    rng = np.random.default_rng(m * 100 + c + e)
    idx, ts = b6_operands(rng, m, c, e, what)
    want = np.asarray(rowsparse_gather_fused(jnp.asarray(idx), jnp.asarray(ts),
                                             e, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_naive(jnp.asarray(idx), jnp.asarray(ts), e)))
    t_idx, t_ts = torch.from_numpy(idx), torch.from_numpy(ts)
    before = b6.rowsparse_gather.launches
    for got in (rowsparse_gather_ref(t_idx, t_ts, e),
                rowsparse_gather_naive(t_idx, t_ts, e),
                b6.rowsparse_gather(t_idx, t_ts, e)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert b6.rowsparse_gather.launches == before   # the CPU launches nothing


def test_b6_wrapper_refuses_bad_operands():
    idx = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        b6.rowsparse_gather(idx, torch.zeros((3, 5)), 8)
    with pytest.raises(ValueError):
        b6.rowsparse_gather(idx, torch.zeros((3, 4)), 0)


# -- the row-sparse frontier closure and cone delete ----------------------------

EXPRS = ["a . b*", "(a | b | c)+", "a . b* . c*", "a? . b*", "a . b . c"]


def _fixpoint_case(seed, n=9):
    """A closure at its fixpoint packed row-sparse (``dist_cap=2``: rows
    in the table), and a batch of three edges (one masked)."""
    jbtt = jsr.BatchedTransitionTable.from_dfas(
        [jax_compile(e) for e in EXPRS], ("a", "b", "c"))
    tbtt = tsr.BatchedTransitionTable.from_dfas(
        [compile_query(e) for e in EXPRS], ("a", "b", "c"), device="cpu")
    rng = np.random.default_rng(seed)
    adj = np.where(rng.random((4, n, n)) < 0.12,
                   rng.integers(1, 50, (4, n, n)).astype(np.float32), NEG_INF)
    adj = adj.astype(np.float32)
    dist0 = jnp.full((len(EXPRS), n, n, jbtt.k), NEG_INF, jnp.float32)
    dist, _, _ = jsr.batched_closure(dist0, jnp.asarray(adj), jbtt, "jnp")
    sd_np = jsd.pack_rows(np.asarray(dist), 2, 64)
    return jbtt, tbtt, adj, sd_np, rng


def _adj_forms(adj, layout):
    if layout == "dense":
        return jnp.asarray(adj), torch.from_numpy(adj.copy())
    jell = jax_pack_ell(adj, 8, 8)
    return (type(jell)(*[jnp.asarray(x) for x in jell]),
            ell_from_numpy(pack_ell(adj, 8, 8), "cpu"))


@pytest.mark.parametrize("op,f_cap,layout", [
    ("insert", 16, "dense"), ("insert", 1, "dense"), ("insert", 16, "ell"),
    ("delete", 16, "dense"), ("delete", 1, "dense")])
def test_rowsparse_frontier_matches(op, f_cap, layout):
    """f_cap=1 overflows (the densify round trip), f_cap=16 does not:
    leaves, rounds, query rounds and FrontierStats equal the reference's."""
    jbtt, tbtt, adj, sd_np, rng = _fixpoint_case(0)
    n = adj.shape[1]
    smask = np.array([True, True, False])
    adj2 = adj.copy()
    if op == "insert":
        src = rng.integers(0, n, (3,))
        dst, lab = rng.integers(0, n, (3,)), rng.integers(0, 3, (3,))
        for s, d, lb, m in zip(src, dst, lab, smask):
            if m:
                adj2[lb, s, d] = max(adj2[lb, s, d], 60.0 + s)
    else:
        lab, src, dst = np.argwhere(adj > NEG_INF)[[0, 3, 5]].T
        for s, d, lb, m in zip(src, dst, lab, smask):
            if m:
                adj2[lb, s, d] = NEG_INF
    qmask = np.array([True, True, False, True, True])
    ja, ta = _adj_forms(adj2, layout)
    jd, td = _pair(sd_np)
    jfn = jsr.frontier_closure if op == "insert" else jsr.frontier_delete
    tfn = tsr.frontier_closure if op == "insert" else tsr.frontier_delete
    jout = jfn(jd, ja, jbtt, "jnp", jnp.asarray(src), jnp.asarray(smask), f_cap,
               query_mask=jnp.asarray(qmask))
    tout = tfn(td, ta, tbtt, "plain", torch.from_numpy(src),
               torch.from_numpy(smask), f_cap, query_mask=torch.from_numpy(qmask))
    _assert_leaves(tout[0], jout[0])
    assert tout[1] == int(jout[1])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    jst = jout[3]
    assert tout[3] == tsr.FrontierStats(
        int(jst.seed_rows), int(jst.max_lane_rows), int(jst.rows_relaxed),
        bool(jst.fell_back))
    assert tout[3].fell_back == (f_cap == 1)


# -- the service's dist_log -----------------------------------------------------


def test_service_dist_log():
    tuples = list(with_deletions(so_like(20, 80, seed=3), ratio=0.05, seed=5))
    kw = dict(window=20.0, slide=2.0, dist_layout="row_sparse", dist_cap=2)
    js, ts = JaxService(**kw), PersistentQueryService(device="cpu", **kw)
    for svc in (js, ts):
        svc.register("q", "a2q . c2a*", engine="dense", n_slots=32)
    rj, rt = js.ingest(Stream(tuples)), ts.ingest(Stream(tuples))
    assert dict(rt) == dict(rj) and rt.invalidated == rj.invalidated
    assert ts.results("q") == js.results("q")
    assert ts.dist_log == js.dist_log != []
    assert ts.dist_log[-1][1]["layout"] == "row_sparse"
    assert ts.dist_log[-1][1]["lost"] == 0
