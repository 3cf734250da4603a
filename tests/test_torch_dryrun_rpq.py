"""The port's launch layer on the CPU: ``repro_torch.launch.dryrun_rpq`` and
the mesh's one-round lowerings against the JAX package, tolerance 0.

* the ring round (``make_ring_round``) over a 2x4 grid of repeated CPU
  devices against the JAX package's unsharded ``relax_round`` on a dist
  that already dominates the base term (tests/test_distributed_relax.py);
* ``relax_round_vchunked`` over that grid against the JAX one called
  unsharded, and the ``mxu`` round (the same with the bucket backend on
  int32 levels) against JAX's ``relax_round`` with ``BucketBackend(8,
  use_pallas=False)``;
* the batched and frontier one-round lowerings on a 2x2 grid against the
  JAX package's unsharded ``batched_relax_round`` and
  ``frontier_relax_round`` (a lane shard whose mask is all False skips);
* the shares the dry run times (``ring_row`` over device (0, 0) alone, the
  lowerings' ``share_fn``) against the same unsharded rounds' block
  (0, 0) on a dist whose other devices' blocks hold no finite entry, where
  the stood-in contributions are exactly the missing peers';
* every cell x mode x grid's analytic record fields against the JAX
  module's constants and the JAX package's automaton, the collective model
  by hand for one cell per mode, the production grid's shapes;
* a tiny CPU cell written, read back from the results cache and rewritten
  with ``force``; the device default raises without a card.

Importing ``repro.launch.dryrun_rpq`` sets ``XLA_FLAGS`` for 512 host
devices when it is unset. The JAX backend is started first, so this
process keeps its devices, and the variable is restored afterwards, so
later test files and subprocesses do not inherit it.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core.automaton import compile_query as jax_compile
from repro.core.backend import BucketBackend as JaxBucket
from repro_torch.core import semiring as tsr
from repro_torch.core.automaton import compile_query
from repro_torch.core.contraction import BucketBackend
from repro_torch.distributed.executor import (batched_round_lowering,
                                              frontier_round_lowering)
from repro_torch.launch import dryrun_rpq as tdr
from repro_torch.launch.mesh import make_host_grid, make_production_grid

N = 64
GRID_2X4 = make_host_grid(4, ["cpu"] * 8)
GRID_2X2 = make_host_grid(2, ["cpu"] * 4)
ALL_MODES = tdr.MODES + ("batched-mxu_bucket",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jdr():
    """``repro.launch.dryrun_rpq``, imported with the backend already up
    and ``XLA_FLAGS`` restored after its import-time default."""
    n_devices = len(jax.devices())
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun_rpq as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    assert len(jax.devices()) == n_devices
    return mod


def _single(seed=0, query="a . b*"):
    """The reference test's operands: (N, N, K) dist and (L, N, N) adjacency
    in [0, 100), half and 60% -inf."""
    dfa = compile_query(query)
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 100, (N, N, dfa.k)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.5] = -np.inf
    adj = rng.uniform(0, 100, (dfa.n_labels, N, N)).astype(np.float32)
    adj[rng.random(adj.shape) < 0.6] = -np.inf
    return (tsr.TransitionTable.from_dfa(dfa, device="cpu"),
            jsr.TransitionTable.from_dfa(jax_compile(query)), dist, adj)


def test_ring_round_matches_unsharded_relax_round():
    tt, jtt, dist, adj = _single()
    dist_hi = np.maximum(dist, np.nanmax(np.where(np.isfinite(adj), adj, np.nan)))
    want = np.asarray(jsr.relax_round(jnp.asarray(dist_hi), jnp.asarray(adj), jtt))
    got = tdr.make_ring_round(GRID_2X4, tt, "plain")(torch.from_numpy(dist_hi),
                                                     torch.from_numpy(adj))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_share_equals_the_rounds_block():
    """Device (0, 0) of the 2x4 ring holds x rows :32 and u columns :16; on
    a dist finite only there (and dominating the base term there) its
    share alone, the received blocks -inf, is the round's block (0, 0)."""
    tt, jtt, dist, adj = _single(6)
    x_l, u_l = N // 2, N // 4
    base = np.asarray(jsr.relax_round(jnp.full(dist.shape, -jnp.inf),
                                      jnp.asarray(adj), jtt))
    held = np.full_like(dist, -np.inf)
    held[:x_l, :u_l] = np.maximum(dist, base)[:x_l, :u_l]
    want = np.asarray(jsr.relax_round(jnp.asarray(held), jnp.asarray(adj),
                                      jtt))[:x_l, :u_l]
    assert (want > held[:x_l, :u_l]).any()      # the round moves the block
    got = tdr.ring_row([torch.from_numpy(held[:x_l, :u_l])],
                       [torch.from_numpy(adj[:, :u_l])], tt, 4, "plain")[0]
    np.testing.assert_array_equal(got.numpy(), want)
    whole = tdr.make_ring_round(GRID_2X4, tt, "plain")(torch.from_numpy(held),
                                                       torch.from_numpy(adj))
    np.testing.assert_array_equal(whole[:x_l, :u_l].numpy(), want)


def test_vchunked_round_matches_jax(jdr):
    tt, jtt, dist, adj = _single(1, "a . b* . c")
    want = np.asarray(jdr.relax_round_vchunked(jnp.asarray(dist),
                                               jnp.asarray(adj), jtt, 16))
    np.testing.assert_array_equal(
        want, np.asarray(jsr.relax_round(jnp.asarray(dist), jnp.asarray(adj), jtt)))
    for grid in (None, GRID_2X4):
        got = tdr.relax_round_vchunked(torch.from_numpy(dist),
                                       torch.from_numpy(adj), tt, 16, grid, "plain")
        np.testing.assert_array_equal(got.numpy(), want)


def test_mxu_round_matches_jax_bucket(jdr):
    tt, jtt, dist, adj = _single(2)
    t = jdr.N_LEVELS

    def lv(x):
        return np.where(np.isfinite(x), np.clip(np.ceil(x / (100.0 / t)), 0, t),
                        0).astype(np.int32)

    dist_lv, adj_lv = lv(dist), lv(adj)
    want = np.asarray(jsr.relax_round(jnp.asarray(dist_lv), jnp.asarray(adj_lv),
                                      jtt, JaxBucket(n_levels=t, use_pallas=False)))
    got = tdr.relax_round_vchunked(torch.from_numpy(dist_lv),
                                   torch.from_numpy(adj_lv), tt, N, GRID_2X4,
                                   BucketBackend(t, use_kernels=False))
    np.testing.assert_array_equal(got.numpy(), want)


def _batched(seed, jdr):
    """The batched cells' table on both sides and (Q, N, N, K) / (L, N, N)
    operands, mostly -inf."""
    labels = sorted(set().union(*[set(jax_compile(q).labels)
                                  for q in jdr.BATCHED_QUERIES]))
    jbtt = jsr.BatchedTransitionTable.from_dfas(
        [jax_compile(q) for q in jdr.BATCHED_QUERIES], labels)
    tbtt = tsr.BatchedTransitionTable.from_dfas(
        [compile_query(q) for q in tdr.BATCHED_QUERIES], labels, device="cpu")
    q = len(tdr.BATCHED_QUERIES)
    rng = np.random.default_rng(seed)
    dist = np.full((q, N, N, tbtt.k), -np.inf, np.float32)
    hit = rng.random(dist.shape) < 0.05
    dist[hit] = rng.uniform(0, 100, hit.sum())
    adj = np.full((tbtt.n_labels, N, N), -np.inf, np.float32)
    hit = rng.random(adj.shape) < 0.1
    adj[hit] = rng.uniform(0, 100, hit.sum())
    return jbtt, tbtt, dist, adj


def test_batched_round_lowering_matches_jax(jdr):
    jbtt, tbtt, dist, adj = _batched(3, jdr)
    q = dist.shape[0]
    mask = np.array([False] * (q // 2) + [True, False] + [True] * (q // 2 - 2))
    want = np.asarray(jsr.batched_relax_round(
        jnp.asarray(dist), jnp.asarray(adj), jbtt, "jnp", jnp.asarray(mask)))
    low = batched_round_lowering(GRID_2X2, tbtt, q, N, "plain")
    got = low.round_fn(torch.from_numpy(dist), torch.from_numpy(adj),
                       torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert low.block_shapes == {"dist": (q // 2, N, N // 2, tbtt.k),
                                "adj_u": (tbtt.n_labels, N // 2, N),
                                "adj_v": (tbtt.n_labels, N, N // 2),
                                "mask": (q // 2,)}


def test_frontier_round_lowering_matches_jax(jdr):
    jbtt, tbtt, dist, adj = _batched(4, jdr)
    q, f = dist.shape[0], 8
    rng = np.random.default_rng(5)
    dirty = torch.from_numpy(rng.random((q, N)) < 0.08)
    dirty[q // 2:] = False      # the second lane shard's rows are all masked
    rows, rowmask, _cnt = tsr.pack_frontier(dirty, f)
    want = np.asarray(jsr.frontier_relax_round(
        jnp.asarray(dist), jnp.asarray(adj), jbtt, "jnp",
        jnp.asarray(rows.numpy().astype(np.int32)), jnp.asarray(rowmask.numpy()))[0])
    got = frontier_round_lowering(GRID_2X2, tbtt, q, N, f, "plain").round_fn(
        torch.from_numpy(dist), torch.from_numpy(adj), rows, rowmask)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_fields(jdr, name, n, query, multi_pod, mode):
    """The reference's analytic fields (dryrun_rpq.py:185-340)."""
    chips = 512 if multi_pod else 256
    dfa = jax_compile(query)
    meta_k, meta_labels, n_trans = dfa.k, dfa.n_labels, len(dfa.transitions())
    dist_shape, adj_shape = (n, n, dfa.k), (dfa.n_labels, n, n)
    if mode.startswith("batched"):
        dfas = [jax_compile(q) for q in jdr.BATCHED_QUERIES]
        labels = sorted(set().union(*[set(d.labels) for d in dfas]))
        btt = jsr.BatchedTransitionTable.from_dfas(dfas, labels)
        meta_k, meta_labels = btt.k, len(labels)
        n_trans = sum(len(d.transitions()) for d in dfas)
        q_cap = -(-len(dfas) // (32 if multi_pod else 16)) * (32 if multi_pod else 16)
        dist_shape = (q_cap, n, n, btt.k)
        adj_shape = (btt.n_labels, n, n)
    frontier = mode.endswith("frontier")
    levels = mode == "mxu" or mode.endswith("mxu_bucket")
    f_cap = min(jdr.F_CAP, n)
    return {
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "k": meta_k, "n_labels": meta_labels, "n_slots": n,
        "state_bytes_per_chip": (np.prod(dist_shape) * 4
                                 + np.prod(adj_shape) * 4) / chips,
        "semiring_ops": (2.0 * n_trans * f_cap * n**2 if frontier
                         else 2.0 * n_trans * n**3),
        "frontier_cap": f_cap if frontier else 0,
        "n_levels": jdr.N_LEVELS if levels else 0,
        "level_dots": jdr.N_LEVELS + 1 if levels else 0,
        "adjacency": {
            "dense_bytes": 4.0 * meta_labels * n**2,
            "ell_cap": jdr.ELL_CAP_ANALYTIC,
            "ell_bytes": (8.0 * meta_labels * n * jdr.ELL_CAP_ANALYTIC
                          + 16.0 * jdr.SPILL_CAP_ANALYTIC),
            "ell_gather_ops": 2.0 * n_trans * f_cap * jdr.ELL_CAP_ANALYTIC * n,
        },
    }


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_fields_match_the_reference(jdr, multi_pod):
    assert tdr.RPQ_CELLS == jdr.RPQ_CELLS
    assert tdr.BATCHED_QUERIES == jdr.BATCHED_QUERIES
    assert (tdr.N_LEVELS, tdr.F_CAP, tdr.ELL_CAP_ANALYTIC, tdr.SPILL_CAP_ANALYTIC) \
        == (jdr.N_LEVELS, jdr.F_CAP, jdr.ELL_CAP_ANALYTIC, jdr.SPILL_CAP_ANALYTIC)
    for name, n, query, vc in jdr.RPQ_CELLS:
        for mode in ALL_MODES:
            plan = tdr.plan_cell(name, n, query, vc, multi_pod, mode)
            want = _jax_fields(jdr, name, n, query, multi_pod, mode)
            assert {k: plan[k] for k in want} == want, (name, mode)
            assert plan["arch"] == f"{name}-{mode}"


def test_wire_model_by_hand():
    """rpq_n4096_k2 on the 16x16 grid: x_l = u_l = N_m = 256, K = 2 for
    "a . b*"; the batched cells' lane shard 0 holds lane 0 ("a*"), its
    rows bucketed to J_l = 8; F = 256."""
    name, n, query, vc = tdr.RPQ_CELLS[0]
    want = {"ring": {"collective-permute": 15 * 256 * 256 * 2 * 4.0},
            "baseline": {"all-gather": 15 * 256 * 256 * 2 * 4.0},
            "mxu": {"all-gather": 15 * 256 * 256 * 2 * 4.0},
            "batched": {"reduce-scatter": 15 / 16 * 8 * 4096 * 4096 * 4.0},
            "batched-mxu_bucket": {"reduce-scatter": 15 / 16 * 8 * 4096 * 4096 * 4.0},
            "batched-frontier": {"reduce-scatter": 15 / 16 * 8 * 256 * 4096 * 4.0}}
    for mode, kinds in want.items():
        plan = tdr.plan_cell(name, n, query, vc, False, mode)
        assert plan["collectives_by_kind_extrap"] == kinds, mode
        assert plan["collective_wire_bytes_extrap"] == sum(kinds.values())
    assert make_production_grid() == ((16, 16), ("data", "model"))
    assert make_production_grid(multi_pod=True) == ((2, 16, 16),
                                                    ("pod", "data", "model"))


def test_tiny_cell_cached_and_forced(tmp_path):
    """Every mode of a 64-slot cell runs its share on the CPU (the plain
    versions, equal to themselves, no launch, the device fields not
    measured); the record is read back from the cache until ``force``."""
    for mode in ALL_MODES:
        r = tdr.run_rpq_cell("tiny", N, "a . b*", 16, False, mode=mode,
                             device="cpu", check_plain=True, results_dir=tmp_path)
        assert r["plain_equal"] and r["max_abs_err"] == 0.0, mode
        assert r["launches"] == {"B1": 0, "B3": 0}
        assert r["device_ms"] is None and r["peak_bytes_per_chip"] is None
        assert r["device"] == "cpu" and r["bound_ms"] > 0
    path = tmp_path / "tiny-ring__ingest_round__pod.json"
    path.write_text(path.read_text().replace('"ok": true', '"ok": "cached"'))
    assert tdr.run_rpq_cell("tiny", N, "a . b*", 16, False, mode="ring",
                            device="cpu", results_dir=tmp_path)["ok"] == "cached"
    assert tdr.run_rpq_cell("tiny", N, "a . b*", 16, False, mode="ring",
                            force=True, device="cpu",
                            results_dir=tmp_path)["ok"] is True


def test_device_defaults_to_the_card(tmp_path):
    """Without a card the default device raises, in the entry point and
    the CLI alike (with one it is the card)."""
    if torch.cuda.is_available():
        assert tdr.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.run_rpq_cell("tiny", N, "a . b*", 16, False, mode="ring",
                         results_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.main(["--cell", "rpq_n4096_k2", "--modes", "ring"])


def _held_by_peer0(dist):
    """The dist with every model peer's columns but peer 0's -inf (2x2)."""
    held = np.full_like(dist, -np.inf)
    held[:, :, :N // 2] = dist[:, :, :N // 2]
    return held


def test_batched_share_equals_the_rounds_block(jdr):
    jbtt, tbtt, dist, adj = _batched(7, jdr)
    held, q, n_m = _held_by_peer0(dist), dist.shape[0], N // 2
    mask = np.array([True, False] + [True] * (q - 2))
    want = np.asarray(jsr.batched_relax_round(
        jnp.asarray(held), jnp.asarray(adj), jbtt, "jnp", jnp.asarray(mask)))
    want = want[:q // 2, :, :n_m]
    assert (want > held[:q // 2, :, :n_m]).any()
    low = batched_round_lowering(GRID_2X2, tbtt, q, N, "plain")
    got = low.share_fn(torch.from_numpy(held[:q // 2, :, :n_m]),
                       torch.from_numpy(adj[:, :n_m]),
                       torch.from_numpy(adj[:, :, :n_m]), mask[:q // 2])
    np.testing.assert_array_equal(got.numpy(), want)
    whole = low.round_fn(torch.from_numpy(held), torch.from_numpy(adj),
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(whole[:q // 2, :, :n_m].numpy(), want)


def test_frontier_share_equals_the_rounds_block(jdr):
    jbtt, tbtt, dist, adj = _batched(8, jdr)
    held, q, n_m, f = _held_by_peer0(dist), dist.shape[0], N // 2, 8
    dirty = torch.from_numpy(np.random.default_rng(9).random((q, N)) < 0.08)
    rows, rowmask, _cnt = tsr.pack_frontier(dirty, f)
    want = np.asarray(jsr.frontier_relax_round(
        jnp.asarray(held), jnp.asarray(adj), jbtt, "jnp",
        jnp.asarray(rows.numpy().astype(np.int32)), jnp.asarray(rowmask.numpy()))[0])
    want = want[:q // 2, :, :n_m]
    assert (want > held[:q // 2, :, :n_m]).any()
    low = frontier_round_lowering(GRID_2X2, tbtt, q, N, f, "plain")
    got = low.share_fn(torch.from_numpy(held[:q // 2, :, :n_m]),
                       torch.from_numpy(adj[:, :n_m]),
                       torch.from_numpy(adj[:, :, :n_m]), rows[:q // 2],
                       rowmask[:q // 2])
    np.testing.assert_array_equal(got.numpy(), want)
