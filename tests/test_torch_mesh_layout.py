"""The mesh executor's state at rest on the grid, on the CPU: over grids of
repeated CPU devices (4x1, 2x2, and 2x2 with each device keeping its
peers' u-row and v-column adjacency blocks apart, the layout of a device
that hosts only some model peers), in the dense, ELL + dense and ELL +
row-sparse layouts with the frontier off and on:

* per event the result and invalidation logs, and after every dispatch the
  state leaves through ``arrays`` (adjacency or ELL leaves, dense dist or
  row-sparse leaves with the overflow table and ``lost``, emitted, clock),
  equal to the port's ``LocalExecutor`` and the JAX package's local
  executor, tolerance 0. One exception, as in the JAX package: with the
  frontier on, a local executor scatters the relaxed rows of a row-sparse
  dist into its slots and table in place, where the mesh (the reference's
  too) relaxes dense slabs and re-packs them; there the mesh's leaves are
  held to the canonical whole-slab pack of the same dist (what the mesh
  stored before its per-shard pack) and its dense dist to the local one
  (the local executor's leaves are held to the JAX package's in
  tests/test_torch_rowsparse_ell.py);
* the per-shard pack against the whole-slab pack, table claims and
  ``lost`` included, with more overflowing rows than the table holds;
* a spy that fails if an ingest or delete dispatch allocates a whole
  (L, N, N) adjacency or a (Q, N, N, K)-sized dist on one device, or moves
  an adjacency tensor between devices (any ``.to(device)`` of one) — and
  that catches the local executor's whole-slab densify;
* the blocks at rest after a growth and after a restore from a local
  engine's exported state.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import carry_reference_state
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.executor import LocalExecutor
from repro_torch.core.sparse_adj import EllAdjacency
from repro_torch.core.sparse_dist import RowSparseDist, _from_dense, rsd_pack_rows
from repro_torch.distributed.executor import MeshExecutor
from _torch_pairs import SO_QUERIES, engine_pair, step, stream
from _torch_spy import spy_dispatches

LAYOUTS = {"dense": dict(adj_layout="dense"),
           "ell": dict(adj_layout="ell"),
           "ell-rs": dict(adj_layout="ell", dist_layout="row_sparse", dist_cap=2)}
N_SLOTS = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class SplitMesh(MeshExecutor):
    """Every device keeps its peers' u and v blocks apart, as a device
    hosting only some model peers does (one CPU device hosts them all)."""

    def _piece_keys(self, dev, n):
        n_m = n // self.n_model
        return [key for m in self._peers_of[dev]
                for key in ((m * n_m, (m + 1) * n_m, 0, n),
                            (0, n, m * n_m, (m + 1) * n_m))]


GRIDS = {"4x1": (MeshExecutor, 1), "2x2": (MeshExecutor, 2),
         "2x2-split": (SplitMesh, 2)}
N_EVENTS = 40


def _mesh_engine(grid, frontier, layout, n_slots=N_SLOTS, queries=SO_QUERIES,
                 **extra):
    cls, model_axis = GRIDS[grid]
    kw = dict(frontier=frontier, frontier_cap=4, ell_cap=2, spill_cap=8,
              **LAYOUTS[layout], **extra)
    return BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
        n_slots=n_slots, batch_size=1,
        executor=cls(["cpu"] * 4, model_axis=model_axis, **kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(arrays):
    """(name, numpy) of every state leaf, the sparse layouts' included."""
    out = []
    for name in ("adj", "dist"):
        x = getattr(arrays, name)
        if isinstance(x, (EllAdjacency, RowSparseDist)) or hasattr(x, "_fields"):
            out += [(f"{name}.{f}", _np(v)) for f, v in zip(x._fields, x)]
        else:
            out.append((name, _np(x)))
    return out + [("emitted", _np(arrays.emitted)), ("now", _np(arrays.now))]


def _assert_leaves_equal(want, got, tag):
    for (name, a), (name2, b) in zip(_leaves(want), _leaves(got)):
        assert name == name2
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {tag}")


def _canonical(arrays, dense):
    """``arrays`` with its row-sparse dist replaced by the whole-slab pack
    of ``dense`` at the same capacities (``lost`` kept: every pack here
    fits the table)."""
    sd = arrays.dist
    packed = _from_dense(dense, sd.dist_cap, sd.ovf_cap)[0]
    return arrays._replace(dist=packed._replace(lost=sd.lost))


def _assert_at_rest(ex: MeshExecutor, tag):
    """Every block at rest is the logical state's slice, on its device."""
    logical = ex.arrays
    a = ex._arrays
    if isinstance(logical.adj, EllAdjacency):
        for dev, rep in ex._ell_reps.items():
            assert all(x.device == dev and torch.equal(x, y)
                       for x, y in zip(rep, logical.adj)), tag
    else:
        for dev, held in a.adj.pieces.items():
            for (r0, r1, c0, c1), t in held.items():
                assert t.device == dev, tag
                assert torch.equal(t, logical.adj[:, r0:r1, c0:c1]), (tag, r0, c0)
    q_l = ex.dist_shape[0] // ex.n_shards
    if isinstance(logical.dist, RowSparseDist):
        for i in range(ex.n_shards):
            lanes = slice(i * q_l, (i + 1) * q_l)
            assert torch.equal(a.dist.idx[i], logical.dist.idx[lanes]), tag
            assert torch.equal(a.dist.ts[i], logical.dist.ts[lanes]), tag
        grids = [(a.emitted, logical.emitted)]
    else:
        grids = [(a.dist, logical.dist), (a.emitted, logical.emitted)]
    for g, whole in grids:
        for i, row in enumerate(g.blocks):
            for m, b in enumerate(row):
                want = whole[i * q_l:(i + 1) * q_l, :, ex._cols(m)]
                assert b.shape == want.shape and torch.equal(b, want), (tag, i, m)


@pytest.mark.parametrize("frontier", ["off", "on"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_leaves_match_local_per_dispatch(layout, frontier):
    """The JAX local engine, the port's local engine and the port's mesh
    on each grid, driven alike with slide expiry: per event the same
    results or invalidations, after every dispatch the same state leaves."""
    _queries, tuples = stream("so")
    je, te = engine_pair(SO_QUERIES, frontier, "dense", n_slots=N_SLOTS,
                         **LAYOUTS[layout])
    meshes = {g: _mesh_engine(g, frontier, layout) for g in ("4x1", "2x2")}
    scatters = layout == "ell-rs" and frontier == "on"
    jax_engines = [] if scatters else [je]
    assert all(m.q_cap == te.q_cap == je.q_cap for m in meshes.values())
    nxt = 2.0
    for i, sgt in enumerate(tuples[:N_EVENTS]):
        if sgt.ts >= nxt:
            for eng in (*jax_engines, te, *meshes.values()):
                eng.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        want = step(te, sgt)
        for j in jax_engines:
            assert step(j, sgt) == want, (i, sgt)
            _assert_leaves_equal(j.executor.arrays, te.executor.arrays, (i, "jax"))
        for g, m in meshes.items():
            assert step(m, sgt) == want, (g, i, sgt)
            got = m.executor.arrays
            if scatters:
                dense = m.executor.dense_dist()
                np.testing.assert_array_equal(
                    dense.numpy(), te.executor.dense_dist().numpy(), err_msg=g)
                _assert_leaves_equal(_canonical(got, dense), got, (g, i))
                _assert_leaves_equal(te.executor.arrays._replace(dist=got.dist),
                                     got, (g, i))
            else:
                _assert_leaves_equal(te.executor.arrays, got, (g, i))
                assert m.executor.dist_stats == te.executor.dist_stats
            assert m.executor.adjacency_stats == te.executor.adjacency_stats
    for g, m in meshes.items():
        assert m.per_query_results == te.per_query_results, g
        assert m.per_query_conflicted == te.per_query_conflicted, g
        _assert_at_rest(m.executor, g)
        if layout == "ell-rs":
            st = m.executor.dist_stats
            assert st["drains"] >= 1 and st["lost"] == 0, (g, st)


def test_per_shard_pack_equals_whole_slab_pack():
    """rsd_pack_rows over lane ranges (2 and 4 shards) against one range:
    the same slot leaves, and one overflow table whose rows are claimed in
    the whole slab's row order, also when more rows overflow than the
    table holds (``lost`` counts the surplus)."""
    rng = np.random.default_rng(5)
    q, n, k = 8, 12, 2
    dense = np.full((q, n, n, k), -np.inf, np.float32)
    hit = rng.random(dense.shape) < 0.12
    dense[hit] = rng.uniform(0.0, 50.0, hit.sum())
    flat = torch.from_numpy(dense).reshape(q, n, n * k)
    counts = (flat > -np.inf).sum(-1)
    for cap, ovf_cap in ((4, 64), (2, 8)):
        whole, _ = _from_dense(torch.from_numpy(dense), cap, ovf_cap,
                               torch.tensor(3, dtype=torch.int32))
        assert int((counts > cap).sum()) > 0
        for shards in (2, 4):
            q_l = q // shards
            idx, ts, table, _reads = rsd_pack_rows(
                [flat[i * q_l:(i + 1) * q_l] for i in range(shards)], cap,
                ovf_cap, torch.tensor(3, dtype=torch.int32), torch.device("cpu"))
            got = RowSparseDist(torch.cat(idx), torch.cat(ts), *table)
            for f, a, b in zip(got._fields, whole, got):
                assert torch.equal(a, b), (cap, shards, f)
    assert int(whole.lost) > 3          # the (2, 8) case overflows the table


def _spied(eng, n_events):
    """Drive ``eng`` over the stream's first sgts with every ingest and
    delete dispatch of its executor under one spy; returns the spy."""
    spy = spy_dispatches(eng.executor)
    _q, tuples = stream("so")
    nxt = 2.0
    for sgt in tuples[:n_events]:
        if sgt.ts >= nxt:
            eng.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        step(eng, sgt)
    return spy


@pytest.mark.parametrize("frontier", ["off", "on"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dispatches_build_no_whole_slab(layout, frontier):
    """On the 2x2 grid no ingest or delete dispatch allocates a whole
    adjacency or dist on one device, or moves an adjacency block, drains
    and re-packs included; the largest legitimate intermediate (a lane
    shard's (J_s, N, N) partial) lies below the dist threshold, so the
    check has teeth."""
    eng = _mesh_engine("2x2", frontier, layout)
    ex = eng.executor
    spy = _spied(eng, N_EVENTS)
    q, n, _, k = ex.dist_shape
    j_s = max(t.qidx.shape[0] for row in ex._tables for t in row)
    assert j_s * n * n < q * n * n * k and j_s != ex.adj_shape[0]
    assert ex.steps >= N_EVENTS // 2
    assert spy.new == [] and spy.moved == [], (spy.new[:4], spy.moved[:4])
    if layout != "dense":
        assert ex.adjacency_stats["repacks"] + ex.adjacency_stats["spill_drains"] > 0
    if layout == "ell-rs":
        assert ex.dist_stats["drains"] > 0


def test_spy_catches_local_whole_densify():
    """The local executor's dense round over a row-sparse dist densifies
    the whole (Q, N, N, K) slab each dispatch: the spy sees it."""
    eng = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in SO_QUERIES],
        n_slots=N_SLOTS, batch_size=1,
        executor=LocalExecutor(None, device="cpu", **LAYOUTS["ell-rs"]))
    spy = _spied(eng, 6)
    assert spy.new, "the spy missed the local whole-slab densify"
    l, n, _ = eng.executor.adj_shape
    with spy:
        torch.zeros((l, n // 2, n)).to("cpu", non_blocking=True)
    assert spy.moved == [(l, n // 2, n)]


@pytest.mark.parametrize("grid", ["2x2", "2x2-split"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_blocks_at_rest_after_growth_and_restore(layout, grid):
    """A mesh engine outgrowing its 8 slots (the vertex axis doubles and
    every block is re-placed), then re-placed from a local engine's
    exported state, interner and results mid-stream: the blocks at rest
    are the logical state's slices, and both engines go on equal."""
    _q, tuples = stream("so")
    mesh = _mesh_engine(grid, "on", layout, n_slots=8)
    local = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in SO_QUERIES],
        n_slots=8, batch_size=1, executor=LocalExecutor(
            None, device="cpu", frontier="on", frontier_cap=4, ell_cap=2,
            spill_cap=8, **LAYOUTS[layout]))
    for sgt in tuples[:30]:
        assert step(local, sgt) == step(mesh, sgt)
    assert mesh.n_slots > 8 and mesh.executor.dist_shape[1] == mesh.n_slots
    _assert_at_rest(mesh.executor, "grown")
    fresh = _mesh_engine(grid, "on", layout, n_slots=mesh.n_slots)
    carry_reference_state(fresh, local.state_arrays(), local.interner_state(),
                          local.results_state())
    _assert_at_rest(fresh.executor, "restored")
    np.testing.assert_array_equal(fresh.executor.dense_dist().numpy(),
                                  local.executor.dense_dist().numpy())
    for i, sgt in enumerate(tuples[30:50]):
        assert step(local, sgt) == step(fresh, sgt), i
    _assert_at_rest(fresh.executor, "after")
