"""The port's ``MeshExecutor`` on the CPU, over grids of repeated CPU
devices — 1x1, 4x1 (lanes over four shards) and 2x2 (two lane shards, the
vertex axis over two model peers) — against the port's ``LocalExecutor``
per event (tests/test_executor.py:75-184 and the mesh cases of
tests/test_backends.py, tests/test_frontier.py, tests/test_sparse_adj.py
and tests/test_sparse_dist.py), and once against the JAX package's
``LocalExecutor``: the reference's own mesh cases fail on the installed
jax, so the mesh is held to its contract, bit-identity with the local
executor. Tolerance 0.

Also: the skip accounting (``shard_rounds_total + skipped ==
n_shards * sync_rounds_total``, the local executor's round counts, skipped
> 0 with mixed-depth lanes), one contraction per shard-round per model
peer (kernel B1's launches on the card), padding lanes silent, the state
never gathered in an ingest or delete dispatch, the device grid, and the
backend name check.
"""
import random

import pytest
import torch

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import RegisteredQuery as JaxQuery
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import BucketBackend, PlainBackend
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.executor import LocalExecutor
from repro_torch.distributed.executor import MeshExecutor, host_devices

QUERIES = ["a*", "a . b*", "(a | b)*", "a . b* . c", "(a . b)+", "a . b . c"]
LABELS = ["a", "b", "c"]
GRIDS = {"1x1": (1, 1), "4x1": (4, 1), "2x2": (4, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(grid, backend=None, **kw):
    k, model_axis = GRIDS[grid]
    return MeshExecutor(["cpu"] * k, model_axis=model_axis, backend=backend, **kw)


def _local(backend=None, **kw):
    return LocalExecutor(backend, device="cpu", **kw)


def _random_stream(rng, n_vertices, n_edges, t_max):
    ts = sorted(rng.sample(range(1, t_max), k=min(n_edges, t_max - 1)))
    return [(rng.randrange(n_vertices), rng.randrange(n_vertices),
             rng.choice(LABELS), float(t)) for t in ts]


def _specs(rng, n_queries, window, make=RegisteredQuery, compile_=compile_query):
    specs = []
    for qi in range(n_queries):
        expr = rng.choice(QUERIES)
        dfa = compile_(expr)
        semantics = "simple" if (dfa.has_containment_property
                                 and rng.random() < 0.4) else "arbitrary"
        specs.append(make(f"q{qi}", dfa, window, semantics))
    return specs


def _events(rng, stream):
    live, events = {}, []
    for (u, v, lab, ts) in stream:
        if live and rng.random() < 0.2:
            du, dv, dl = rng.choice(sorted(live))
            del live[(du, dv, dl)]
            events.append(("-", du, dv, dl, ts))
        else:
            live[(u, v, lab)] = ts
            events.append(("+", u, v, lab, ts))
    return events


def _step(eng, op, u, v, lab, ts):
    return eng.insert(u, v, lab, ts) if op == "+" else eng.delete(u, v, lab, ts)


def _assert_lanewise(tag, n_queries, fl, fm):
    """Local lanes == the mesh's first lanes; the mesh's padding lanes (its
    lane capacity rounds to the shard count) stay silent."""
    for qi in range(n_queries):
        assert fl[qi] == fm[qi], (tag, qi, fl[qi] ^ fm[qi])
    assert all(not s for s in fm[n_queries:]), (tag, "padding lane emitted")


def _drive_pair(local, mesh, events, nq, expire_every=6, check_every=9):
    for i, ev in enumerate(events):
        _assert_lanewise(i, nq, _step(local, *ev), _step(mesh, *ev))
        if i % expire_every == expire_every - 1:
            local.expire(ev[-1])
            mesh.expire(ev[-1])
        if i % check_every == check_every - 1:
            for qi in range(nq):
                assert local.current_results(qi) == mesh.current_results(qi)
    for qi in range(nq):
        assert local.per_query_results[qi] == mesh.per_query_results[qi]
        assert local.per_query_conflicted[qi] == mesh.per_query_conflicted[qi]
    # the state itself, lane for lane; padding lanes hold nothing
    md, ld = mesh.executor.dense_dist(), local.executor.dense_dist()
    assert torch.equal(md[:local.q_cap], ld)
    assert not bool((md[local.q_cap:] > float("-inf")).any())
    assert torch.equal(mesh.executor.dense_emitted()[:local.q_cap],
                       local.executor.dense_emitted())


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_matches_local_per_event(grid):
    """Inserts, deletions and expiry, mixed semantics, 3 queries on a lane
    capacity padded to the shard count: every event's new results and
    invalidations equal the local executor's."""
    for seed in range(2):
        rng = random.Random(seed)
        window = rng.choice([10.0, 25.0])
        specs = _specs(rng, 3, window)
        local = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1,
                                      executor=_local())
        mesh = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1,
                                     executor=_mesh(grid))
        assert mesh.q_cap % mesh.executor.n_shards == 0
        _drive_pair(local, mesh, _events(rng, _random_stream(rng, 6, 24, 70)), 3)


def test_mesh_matches_jax_local_per_event():
    """The 2x2 mesh against the JAX package's local executor, per event."""
    rng = random.Random(3)
    window = 25.0
    specs = _specs(rng, 4, window)
    jspecs = _specs(random.Random(3), 4, window, make=JaxQuery,
                    compile_=jax_compile)
    assert [s.path_semantics for s in jspecs] == [s.path_semantics for s in specs]
    jax_local = JaxEngine(jspecs, n_slots=16, batch_size=1)
    mesh = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1,
                                 executor=_mesh("2x2"))
    events = _events(rng, _random_stream(rng, 7, 28, 80))
    for i, ev in enumerate(events):
        _assert_lanewise(i, 4, _step(jax_local, *ev), _step(mesh, *ev))
        if i % 5 == 4:
            jax_local.expire(ev[-1])
            mesh.expire(ev[-1])
    for qi in range(4):
        assert jax_local.per_query_results[qi] == mesh.per_query_results[qi]
    assert (mesh.total_rounds, mesh.total_query_rounds) == \
        (jax_local.total_rounds, jax_local.total_query_rounds)


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_churn_mid_stream_matches_local(grid):
    """Registration and deregistration mid-stream: the lane layouts differ
    (shard-multiple padding, reclaimed holes), the streams match by name."""
    rng = random.Random(7)
    window = 30.0
    base = [RegisteredQuery("q0", compile_query("a . b*"), window),
            RegisteredQuery("q1", compile_query("(a | b)*"), window)]
    local = BatchedDenseRPQEngine(base, n_slots=16, batch_size=1,
                                  executor=_local())
    mesh = BatchedDenseRPQEngine(base, n_slots=16, batch_size=1,
                                 executor=_mesh(grid))
    late = RegisteredQuery("late", compile_query("a*"), window)
    for i, (u, v, lab, ts) in enumerate(_random_stream(rng, 6, 30, 90)):
        if i == 10:
            assert local.register_query(late) == mesh.register_query(late)
        if i == 20:
            local.deregister_query("q0")
            mesh.deregister_query("q0")
        fl, fm = local.insert(u, v, lab, ts), mesh.insert(u, v, lab, ts)
        for qi_l, spec in local.live_items():
            assert fl[qi_l] == fm[mesh.lane_of(spec.name)], (i, spec.name)
        live = {mesh.lane_of(s.name) for _q, s in local.live_items()}
        assert all(not fm[q] for q in range(mesh.q_cap) if q not in live), i
        if i % 7 == 6:
            local.expire(ts)
            mesh.expire(ts)
    for qi_l, spec in local.live_items():
        assert local.per_query_results[qi_l] == \
            mesh.per_query_results[mesh.lane_of(spec.name)]


class CountingBackend(PlainBackend):
    """The plain backend, counting its batched contractions (kernel B1's
    launches when the kernel backend runs on the card)."""

    def __init__(self):
        self.calls = 0

    def contract_rows(self, d_s, a_l):
        self.calls += 1
        return super().contract_rows(d_s, a_l)


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_skip_accounting_consistent(grid):
    """shard_rounds + skipped == n_shards * sync_rounds; rounds and query
    rounds equal the local executor's; with mixed-depth lanes some shard
    settles early; one contraction per shard-round per model peer."""
    rng = random.Random(1)
    specs = [RegisteredQuery(f"q{i}", compile_query(e), 30.0)
             for i, e in enumerate(QUERIES[:4])]
    local = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1,
                                  executor=_local())
    backend = CountingBackend()
    ex = _mesh(grid, backend)
    mesh = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1, executor=ex)
    for (u, v, lab, ts) in _random_stream(rng, 8, 25, 70):
        local.insert(u, v, lab, ts)
        mesh.insert(u, v, lab, ts)
    assert mesh.total_query_rounds == local.total_query_rounds
    assert mesh.total_rounds == local.total_rounds == ex.sync_rounds_total
    assert (ex.shard_rounds_total + ex.skipped_shard_rounds_total
            == ex.n_shards * ex.sync_rounds_total)
    assert backend.calls == ex.n_model * ex.shard_rounds_total
    if ex.n_shards > 1:
        assert ex.skipped_shard_rounds_total > 0
    else:
        assert ex.skipped_shard_rounds_total == 0


def _layout_pair(grid, seed, frontier, batch_size=1, **kw):
    """A local dense engine and a mesh with the frontier, the ELL
    adjacency and the row-sparse dist (``kw`` overrides), driven per event
    with churn-free streams of 14 vertices."""
    rng = random.Random(seed)
    specs = _specs(rng, 3, 15.0)
    events = _events(rng, _random_stream(rng, 14, 80, 60))
    local = BatchedDenseRPQEngine(specs, n_slots=24, batch_size=batch_size,
                                  executor=_local())
    opts = dict(frontier=frontier, frontier_cap=4, adj_layout="ell", ell_cap=2,
                dist_layout="row_sparse", dist_cap=4)
    opts.update(kw)
    mesh = BatchedDenseRPQEngine(specs, n_slots=24, batch_size=batch_size,
                                 executor=_mesh(grid, **opts))
    for i in range(0, len(events), batch_size):
        chunk = events[i:i + batch_size]
        ins = [e[1:] for e in chunk if e[0] == "+"]
        dels = [e[1:] for e in chunk if e[0] == "-"]
        for part, fn in ((ins, "insert_batch"), (dels, "delete_batch")):
            if part:
                _assert_lanewise(i, 3, getattr(local, fn)(part),
                                 getattr(mesh, fn)(part))
        if i % 5 == 4:
            local.expire(chunk[-1][-1])
            mesh.expire(chunk[-1][-1])
    for qi in range(3):
        assert local.per_query_results[qi] == mesh.per_query_results[qi]
    assert local.retained_edges() == mesh.retained_edges()
    return mesh.executor


@pytest.mark.parametrize("frontier", ["on", "auto"])
def test_sparse_layouts_match_dense_local(frontier):
    """The frontier (per-shard fallback on overflow) over the ELL adjacency
    and the row-sparse dist, both densified per dispatch on the mesh."""
    ex = _layout_pair("2x2", 4, frontier)
    fst = ex.frontier_stats
    assert fst["dispatches"] > fst["fallbacks"] >= 1
    assert fst["delete_dispatches"] >= 1
    assert ex.dist_stats["lost"] == 0


def test_ell_overflow_spill_regression_frontier_mesh():
    """ell_cap=1 and an 8-entry spill ring: the budget forces drains."""
    ex = _layout_pair("2x2", 5, "auto", batch_size=4, ell_cap=1, spill_cap=8,
                      dist_layout="dense")
    st = ex.adjacency_stats
    assert st["spill_drains"] > 0 and st["repacks"] > 0, st


def test_overflow_table_regression_frontier_mesh():
    """dist_cap=1 and a 512-row table: rows overflow into the table (each
    dispatch re-packs the densified dist), nothing is lost."""
    ex = _layout_pair("4x1", 6, "auto", batch_size=4, adj_layout="dense",
                      dist_cap=1, dist_ovf_cap=512)
    assert ex.dist_stats["lost"] == 0, ex.dist_stats
    assert int(ex.arrays.dist.ovf_ptr) > 0


@pytest.mark.parametrize("grid", ["4x1", "2x2"])
def test_bucket_backend_per_shard_matches_local(grid):
    """The bucket backend per shard, with churn and deletions: the same
    stream as the bucket backend on the local executor."""
    rng = random.Random(7)
    window = 25.0
    base = [RegisteredQuery("q0", compile_query("a . b*"), window),
            RegisteredQuery("q1", compile_query("(a | b)*"), window)]
    local = BatchedDenseRPQEngine(base, n_slots=12, batch_size=1,
                                  executor=_local(BucketBackend(8)))
    mesh = BatchedDenseRPQEngine(base, n_slots=12, batch_size=1,
                                 executor=_mesh(grid, BucketBackend(8)))
    late = RegisteredQuery("late", compile_query("a*"), window)
    for i, ev in enumerate(_events(rng, _random_stream(rng, 6, 24, 70))):
        if i == 8:
            assert local.register_query(late) == mesh.register_query(late)
        if i == 16:
            local.deregister_query("q0")
            mesh.deregister_query("q0")
        fl, fm = _step(local, *ev), _step(mesh, *ev)
        for qi_l, spec in local.live_items():
            assert fl[qi_l] == fm[mesh.lane_of(spec.name)], (i, spec.name)
        if i % 6 == 5:
            local.expire(ev[-1])
            mesh.expire(ev[-1])
    for qi_l, spec in local.live_items():
        assert local.per_query_results[qi_l] == \
            mesh.per_query_results[mesh.lane_of(spec.name)]


def test_state_stays_sharded_between_dispatches():
    """Ingest and delete dispatches join only their (Q, N, N) result
    matrices, never the dist; the dist blocks are updated in place."""
    rng = random.Random(2)
    specs = _specs(rng, 3, 25.0)
    ex = _mesh("2x2")
    eng = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1, executor=ex)
    events = _events(rng, _random_stream(rng, 6, 24, 70))
    _step(eng, *events[0])
    blocks = [b for row in ex._arrays.dist.blocks for b in row]
    joined = []
    join = ex._join

    def spy(grid_blocks):
        joined.append(grid_blocks[0][0].dim())
        return join(grid_blocks)

    ex._join = spy
    for ev in events[1:]:
        _step(eng, *ev)
    assert joined and set(joined) == {3}
    assert [b for row in ex._arrays.dist.blocks for b in row] == blocks


def test_host_devices_grid():
    assert host_devices(2, ["cpu"] * 4) == [[torch.device("cpu")] * 2] * 2
    assert host_devices(1, ["cpu"] * 3) == [[torch.device("cpu")]] * 3
    assert host_devices(8, ["cpu"] * 2) == [[torch.device("cpu")] * 2]
    ex = MeshExecutor(["cpu"] * 4, model_axis=2)
    assert (ex.n_shards, ex.n_model, ex.q_multiple, ex.n_multiple) == (2, 2, 2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshExecutor()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshExecutor(["cuda:0"] * 4)
    with pytest.raises(ValueError):
        MeshExecutor([])


def test_unknown_backend_raises():
    """tests/test_backends.py:369's mesh case on the port's names."""
    with pytest.raises(ValueError, match="known backends"):
        MeshExecutor(["cpu"], backend="mxu-bucket")
    with pytest.raises(ValueError, match="unknown frontier"):
        MeshExecutor(["cpu"], frontier="sideways")
