"""Tests that need the CUDA card: kernels B1-B6 against their plain
versions on the card (B5 on float32 timestamps and on int32 levels), and
the port's engine on the card against itself on the CPU (dense and
row-sparse dist, the float and the bucket backend, and the legacy
single-query closure), and live query churn (registrations into a grown
and a freed lane mid-stream, with ``make_churn_oracle``); the service's
checkpoints on the card (restored on
the card with every executor tensor there, and across card and CPU) and
the supervised service's crash-recovery identity on the card; the mesh
executor over ``["cuda:0"] * 4`` against the local executor on the card;
the LM serving path, one LM train step and the LM dry run's device
shares on the card against the CPU.

Marked ``gpu``; each skips (from the ``cuda`` fixture, never at import or
collection) where there is no card. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery, make_churn_oracle
from repro_torch.core.contraction import BucketBackend, resolve_backend
from repro_torch.core.semiring import TransitionTable, closure
from repro_torch.core.sparse_adj import ell_insert, pack_ell_dense
from repro_torch.kernels.bucket import bucket as b3
from repro_torch.kernels.bucket.ref import bucket_maxmin_fused_ref, bucket_maxmin_ref
from repro_torch.kernels.ell import ell as b5
from repro_torch.core import semiring
from repro_torch.kernels.ell.ref import ell_contract_rows_ref, ell_gather_contract_ref
from repro_torch.kernels.maxmin import maxmin as b1
from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref, maxmin_matmul_ref
from repro_torch.kernels.rowsparse import rowsparse as b6
from repro_torch.kernels.rowsparse.ref import rowsparse_gather_ref
from repro_torch.streaming.generators import so_like, with_deletions

from _torch_churn import DEREGISTER, LATE1, LATE2, churn_case
from _torch_levels import PATTERNS as LEVEL_PATTERNS
from _torch_levels import level_operands

pytestmark = pytest.mark.gpu

CASES = [(1, 8, 8, 8), (1, 128, 128, 128), (1, 130, 70, 200), (1, 1, 256, 33),
         (1, 257, 1, 129), (1, 64, 512, 64), (3, 4, 40, 40), (5, 16, 33, 33),
         (2, 1, 7, 19), (7, 23, 5, 64), (1, 130, 70, 30), (4, 300, 260, 270)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand_ts(rng, shape, dtype):
    x = rng.uniform(0.0, 1000.0, shape).astype(dtype)
    x[rng.random(shape) > 0.7] = -np.inf
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("J,m,k,n", CASES)
def test_b1_kernel_equals_plain_version(cuda, J, m, k, n, dtype):
    rng = np.random.default_rng(J + m + k + n)
    a = torch.from_numpy(_rand_ts(rng, (J, m, k), dtype)).to(cuda)
    b = torch.from_numpy(_rand_ts(rng, (J, k, n), dtype)).to(cuda)
    a[:, : max(1, m // 5)] = float("-inf")
    before = b1.maxmin_matmul_fused.launches
    out = b1.maxmin_matmul_fused(a, b)
    torch.cuda.synchronize()
    assert b1.maxmin_matmul_fused.launches == before + 1
    assert torch.equal(out, maxmin_matmul_fused_ref(a, b))


# block-sparse operands on the kernel's own tiles (128 x 16 of a, 16 x 128
# of b), which the occupancy pre-pass flags and the product skips; values
# with the sign bit set (all of them, or one in a kept tile), which send a
# block from the integer compare path to the float one; ragged
# m, k, n (not multiples of the tile or of 4, so the 4-byte copy path),
# the aligned 16-byte path, and the frontier's skinny m in {4, 32}
SPARSE_SHAPES = [(2, 300, 260, 270), (1, 128, 128, 128), (3, 4, 2048, 300),
                 (2, 32, 1000, 512), (2, 257, 49, 131), (1, 130, 70, 30)]
SPARSE_PATTERNS = ["a_tiles", "b_tiles", "both_tiles", "all_neg_inf", "corners",
                   "signed", "one_negative"]
A_TILE, B_TILE = (128, 16), (16, 128)


def _tiles(x, tile):
    """(slices of) every tile of x (J, R, C)."""
    _, r, c = x.shape
    return [(slice(r0, r0 + tile[0]), slice(c0, c0 + tile[1]))
            for r0 in range(0, r, tile[0]) for c0 in range(0, c, tile[1])]


def _clear_tiles(rng, x, tile, k_axis):
    """Most tiles of x all -inf, each j on its own draw; the first k tile
    (k along ``k_axis``, 1 or 2) stays, so a and b both hold one."""
    for j in range(x.shape[0]):
        for rs, cs in _tiles(x, tile):
            first_k = (rs if k_axis == 1 else cs).start == 0
            if not first_k and rng.random() < 0.7:
                x[j, rs, cs] = -np.inf


def _corners_only(rng, x, tile):
    """x all -inf but for the four corner entries of every tile."""
    out = np.full_like(x, -np.inf)
    for rs, cs in _tiles(x, tile):
        r1, c1 = min(rs.stop, x.shape[1]) - 1, min(cs.stop, x.shape[2]) - 1
        for r in (rs.start, r1):
            for c in (cs.start, c1):
                out[:, r, c] = rng.uniform(0.0, 1000.0, x.shape[0])
    return out


def _sparse_operands(rng, pattern, J, m, k, n, dtype):
    a = _rand_ts(rng, (J, m, k), dtype)
    b = _rand_ts(rng, (J, k, n), dtype)
    if pattern in ("a_tiles", "both_tiles"):
        _clear_tiles(rng, a, A_TILE, k_axis=2)
    if pattern in ("b_tiles", "both_tiles"):
        _clear_tiles(rng, b, B_TILE, k_axis=1)
    if pattern == "all_neg_inf":
        a[:], b[:] = -np.inf, -np.inf
    if pattern == "corners":
        a, b = _corners_only(rng, a, A_TILE), _corners_only(rng, b, B_TILE)
    if pattern == "signed":                      # values in [-500, 500)
        a, b = a - dtype(500), b - dtype(500)
    if pattern == "one_negative":
        _clear_tiles(rng, a, A_TILE, k_axis=2)
        a[0, m // 2, 1 % k] = dtype(-3.0)        # in the first k tile, kept
    return a, b


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("J,m,k,n", SPARSE_SHAPES)
@pytest.mark.parametrize("pattern", SPARSE_PATTERNS)
def test_b1_b2_on_block_sparse_operands(cuda, pattern, J, m, k, n, dtype):
    """B1 (with its occupancy pre-pass) and B2 (J = 1) equal their plain
    versions where whole operand tiles are -inf: the skipped k steps
    change nothing, and a lone finite entry in any corner of a tile keeps
    its tile; and where values have the sign bit set, which send a block
    from the integer compare path to the float one."""
    rng = np.random.default_rng(J * 7 + m + k + n + SPARSE_PATTERNS.index(pattern))
    a_np, b_np = _sparse_operands(rng, pattern, J, m, k, n, dtype)
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    before = (b1.maxmin_matmul_fused.launches, b1.maxmin_matmul.launches)
    out = b1.maxmin_matmul_fused(a, b)
    pair = b1.maxmin_matmul(a[0].contiguous(), b[0].contiguous())
    torch.cuda.synchronize()
    assert (b1.maxmin_matmul_fused.launches, b1.maxmin_matmul.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = maxmin_matmul_fused_ref(a, b)
    assert torch.equal(out, ref)
    assert torch.equal(pair, maxmin_matmul_ref(a[0], b[0]))
    if pattern == "all_neg_inf":
        assert bool(torch.isneginf(out).all())
    else:
        assert bool(torch.isfinite(ref).any())      # the case exercises something


def test_b1_on_misaligned_views(cuda):
    """Contiguous operands whose base is not 16-byte aligned (a view one
    element into its storage) take the 4-byte copy path."""
    rng = np.random.default_rng(11)
    base_a = torch.from_numpy(_rand_ts(rng, (2 * 64 * 128 + 1,), np.float32)).to(cuda)
    base_b = torch.from_numpy(_rand_ts(rng, (2 * 128 * 96 + 1,), np.float32)).to(cuda)
    a = base_a[1:].view(2, 64, 128)
    b = base_b[1:].view(2, 128, 96)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    out = b1.maxmin_matmul_fused(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, maxmin_matmul_fused_ref(a, b))


def test_b1_refuses_non_contiguous(cuda):
    a = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        b1.maxmin_matmul_fused(a.transpose(1, 2), a)


def test_engine_on_card_equals_engine_on_cpu(cuda):
    queries = [("q1", "a2q . c2a*", "arbitrary"),
               ("q2", "(a2q | c2a | c2q)+", "arbitrary"),
               ("q3", "a2q . c2a* . c2q*", "simple")]

    def engine(device):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
            n_slots=16, batch_size=1, device=device)

    gpu, cpu = engine(cuda), engine("cpu")
    stream = with_deletions(so_like(n_vertices=24, n_edges=120, seed=3),
                            ratio=0.05, seed=1)
    nxt = 2.0
    launches = b1.maxmin_matmul_fused.launches
    for sgt in stream:
        if sgt.ts >= nxt:
            gpu.expire(sgt.ts)
            cpu.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        if sgt.op == "+":
            assert gpu.insert(*sgt.as_edge()) == cpu.insert(*sgt.as_edge())
        else:
            assert gpu.delete(*sgt.as_edge()) == cpu.delete(*sgt.as_edge())
    assert torch.equal(gpu.batched_arrays.dist.cpu(), cpu.batched_arrays.dist)
    assert b1.maxmin_matmul_fused.launches - launches == gpu.total_rounds > 0



def test_churn_on_card_equals_cpu(cuda):
    """One stream of tests/test_query_churn.py's randomized churn scenario
    (seed 0): a late registration, a deregistration and a registration
    into the freed lane mid-stream, on the card and on the CPU; every
    event's fresh results and invalidations, the registrations' initial
    answers and the seeds of ``make_churn_oracle`` built on each device
    equal, and B1 launched once per closure round of the card's group
    (the card oracle's launches apart)."""
    case = churn_case(0)
    window = case["window"]
    launched = 0

    def on_card(method, *args):
        """The card group's call, its B1 launches counted."""
        nonlocal launched
        before = b1.maxmin_matmul_fused.launches
        out = getattr(gpu, method)(*args)
        launched += b1.maxmin_matmul_fused.launches - before
        return out

    def group(device):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), w, s) for n, e, w, s in case["specs"]],
            n_slots=16, batch_size=1, device=device)

    def register(name, expr, semantics="arbitrary"):
        seeds = [make_churn_oracle(compile_query(expr), g, window, 16,
                                   path_semantics=semantics)[1] for g in (gpu, cpu)]
        assert seeds[0] == seeds[1], name
        spec = RegisteredQuery(name, compile_query(expr), window, semantics)
        assert on_card("register_query", spec) == cpu.register_query(spec) == seeds[0]
        assert gpu.lane_of(name) == cpu.lane_of(name)

    gpu, cpu = group(cuda), group("cpu")
    for i, (op, u, v, lab, ts) in enumerate(case["events"]):
        if i == LATE1:
            register("late1", *case["late1"])
        elif i == DEREGISTER:
            gpu.deregister_query("q1")
            cpu.deregister_query("q1")
        elif i == LATE2:
            register("late2", case["late2"])
            assert gpu.lane_of("late2") == 1
        method = "insert" if op == "+" else "delete"
        assert on_card(method, u, v, lab, ts) == getattr(cpu, method)(u, v, lab, ts), i
        if i % 7 == 6:
            on_card("expire", ts)
            cpu.expire(ts)
    assert gpu.per_query_results == cpu.per_query_results
    assert gpu.q_cap == cpu.q_cap
    assert torch.equal(gpu.batched_arrays.dist.cpu(), cpu.batched_arrays.dist)
    assert launched == gpu.total_rounds > 0


# tests/test_torch_kernels.py: B5_CASES (J, M, U, E)
B5_CASES = [(2, 5, 12, 3), (1, 1, 9, 1), (3, 7, 13, 2), (4, 16, 33, 4),
            (1, 130, 257, 8), (48, 4, 2048, 2), (6, 300, 700, 5)]
# a row wider than one block's shared memory (the kernel splits its
# columns), aligned and ragged
B5_WIDE = [(1, 2, 70000, 3), (1, 2, 70001, 2)]


def _ell_operands(rng, j, m, u, e, device):
    d = rng.uniform(0.0, 1000.0, (j, m, u)).astype(np.float32)
    d[rng.random(d.shape) > 0.4] = -np.inf
    idx = rng.integers(0, u, (j, u, e)).astype(np.int32)
    ts = rng.uniform(0.0, 1000.0, (j, u, e)).astype(np.float32)
    ts[rng.random(ts.shape) > 0.6] = -np.inf
    ts[:, : max(1, u // 7)] = -np.inf            # all-free rows
    idx[:, :, 0] = idx[:, :, -1]                 # duplicate destinations
    return (torch.from_numpy(d).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(ts).to(device))


@pytest.mark.parametrize("J,M,U,E", B5_CASES)
def test_b5_kernel_equals_plain_version(cuda, J, M, U, E):
    rng = np.random.default_rng(J * 1000 + M + U + E)
    d, idx, ts = _ell_operands(rng, J, M, U, E, cuda)
    before = b5.ell_gather_contract.launches
    out = b5.ell_gather_contract(d, idx, ts)
    torch.cuda.synchronize()
    assert b5.ell_gather_contract.launches == before + 1
    assert torch.equal(out, ell_gather_contract_ref(d, idx, ts))


def test_b5_refuses_bad_operands(cuda):
    d = torch.zeros((2, 3, 4), device=cuda)
    idx = torch.zeros((2, 4, 2), dtype=torch.int32, device=cuda)
    ts = torch.zeros((2, 4, 2), device=cuda)
    with pytest.raises(TypeError):
        b5.ell_gather_contract(d, idx.long(), ts)
    with pytest.raises(TypeError):
        b5.ell_gather_contract(d.half(), idx, ts)
    with pytest.raises(ValueError, match="contiguous"):
        b5.ell_gather_contract(d.transpose(1, 2).contiguous().transpose(1, 2),
                               idx, ts)


def _rows_operands(rng, j, m, u, e, device, levels=False):
    """B5's whole entry's operands: ELL leaves of 3 labels, repeating
    labels, and a 64-entry ring whose every entry is live, two of them with
    dst outside [0, U) and one with src outside it (dropped)."""
    n_labels, s = 3, 64
    d = rng.uniform(0.0, 1000.0, (j, m, u)).astype(np.float32)
    d[rng.random(d.shape) > 0.4] = -np.inf
    idx = rng.integers(0, u, (n_labels, u, e)).astype(np.int32)
    idx[:, :, 0] = idx[:, :, -1]                 # duplicate destinations
    ts = rng.uniform(0.0, 1000.0, (n_labels, u, e)).astype(np.float32)
    ts[rng.random(ts.shape) > 0.6] = -np.inf
    labs = rng.integers(0, n_labels, (j,)).astype(np.int32)
    src, dst = rng.integers(0, u, (2, s)).astype(np.int32)
    lab = (np.arange(s) % n_labels).astype(np.int32)
    sts = rng.uniform(1.0, 1000.0, s).astype(np.float32)
    dst[1], dst[2], src[3] = u, u + 9, u
    if levels:
        d, ts, sts = (np.where(np.isfinite(x), np.nan_to_num(x, neginf=0.0) // 100 + 1,
                               0).astype(np.int32) for x in (d, ts, sts))
    t = [torch.from_numpy(x).to(device) for x in (d, idx, ts, labs, src, dst, lab, sts)]
    return t[0], t[1], t[2], t[3], tuple(t[4:])


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("J,M,U,E", B5_CASES + B5_WIDE)
def test_b5_whole_entry_equals_plain_version(cuda, J, M, U, E, levels):
    """The whole entry (ELL leaves, labels and a full ring) on float32 and
    int32: one launch a call, equal to its plain version with int32 and
    int64 labels."""
    rng = np.random.default_rng(J * 1000 + M + U + E + 7)
    d, idx, ts, labs, ring = _rows_operands(rng, J, M, U, E, cuda, levels)
    zero = 0 if levels else float("-inf")
    for lab_t in (labs, labs.long()):
        before = (b5.ell_contract_rows.launches, b5.ell_gather_contract.launches)
        out = b5.ell_contract_rows(d, idx, ts, lab_t, *ring)
        torch.cuda.synchronize()
        assert (b5.ell_contract_rows.launches, b5.ell_gather_contract.launches) == \
            (before[0] + 1, before[1])
        assert out.dtype == d.dtype
        assert torch.equal(out, ell_contract_rows_ref(d, idx, ts, lab_t, *ring,
                                                      zero=zero))


def test_b5_whole_entry_refuses_bad_operands(cuda):
    rng = np.random.default_rng(1)
    d, idx, ts, labs, ring = _rows_operands(rng, 2, 3, 8, 2, cuda)
    with pytest.raises(TypeError):
        b5.ell_contract_rows(d, idx.long(), ts, labs, *ring)
    with pytest.raises(TypeError):
        b5.ell_contract_rows(d.int(), idx, ts, labs, *ring)      # one element type
    with pytest.raises(TypeError):
        b5.ell_contract_rows(d, idx, ts, labs.float(), *ring)
    with pytest.raises(TypeError):
        b5.ell_contract_rows(d, idx, ts, labs, ring[0].long(), *ring[1:])
    with pytest.raises(ValueError, match="contiguous"):
        b5.ell_contract_rows(d.repeat(1, 1, 2)[:, :, ::2], idx, ts, labs, *ring)
    with pytest.raises(ValueError, match="contiguous"):
        b5.ell_contract_rows(d, idx.transpose(0, 1).contiguous().transpose(0, 1),
                             ts, labs, *ring)


def test_b5_with_a_full_spill_ring(cuda):
    """contract_rows_ell on the card with every ring entry live: kernel B5,
    with the ring folded in, in one launch, equals the plain backend on the
    same inputs."""
    rng = np.random.default_rng(5)
    n, labels, cap = 40, 3, 2
    dense = torch.full((labels, n, n), float("-inf"), device=cuda)
    ell = pack_ell_dense(dense, cap, 16)
    k = 0
    while int(ell.spill_ptr) < 16:       # overfull rows spill into the ring
        u, l = int(rng.integers(0, 4)), int(rng.integers(0, labels))
        v = int(rng.integers(0, n))
        ell = ell_insert(ell, [u], [v], [l],
                         torch.tensor([float(k + 1)], device=cuda), [True])
        k += 1
    assert bool((ell.spill_ts > float("-inf")).all())
    d = torch.from_numpy(rng.uniform(0, 500, (6, 9, n)).astype(np.float32)).to(cuda)
    labs = torch.tensor([0, 1, 2, 0, 1, 2], device=cuda)
    before = (b5.ell_contract_rows.launches, b5.ell_gather_contract.launches)
    out = resolve_backend("cuda").contract_rows_ell(d, ell, labs)
    torch.cuda.synchronize()
    assert (b5.ell_contract_rows.launches, b5.ell_gather_contract.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(out, resolve_backend("plain").contract_rows_ell(d, ell, labs))


#: the dense ELL round's byte budget in the engine tests below: 3
#: transition rows a chunk at n_slots=16, so a dense round launches B5
#: ceil(J / 3) times
SMALL_ROUND_BYTES = 3 * 2 * 16 * 16 * 4


@pytest.mark.parametrize("adj_layout", ["ell", "dense"])
def test_frontier_engine_on_card_equals_engine_on_cpu(cuda, adj_layout, monkeypatch):
    """frontier="auto" from a tiny capacity (fallbacks, growth, cone
    deletes) and, for ELL, a tiny degree capacity (rows spill into the
    ring) and a dense round in chunks of 3 transition rows: per event and
    in the end state, the card equals the CPU, and on the card the ELL
    path launches B5 exactly once per frontier round and once per chunk
    of a dense round, and B1 never."""
    monkeypatch.setattr(semiring, "ELL_ROUND_BYTES", SMALL_ROUND_BYTES)
    queries = [("q1", "a2q . c2a*", "arbitrary"),
               ("q2", "(a2q | c2a | c2q)+", "arbitrary")]

    def engine(device):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
            n_slots=16, batch_size=1, frontier="auto", frontier_cap=2,
            adj_layout=adj_layout, ell_cap=2, device=device)

    gpu, cpu = engine(cuda), engine("cpu")
    stream = with_deletions(so_like(n_vertices=24, n_edges=160, seed=4),
                            ratio=0.05, seed=2)
    launches = (b1.maxmin_matmul_fused.launches, b5.ell_contract_rows.launches)
    rounds0, contractions0 = gpu.total_rounds, gpu.executor.ell_contractions_total
    nxt = 2.0
    for sgt in stream:
        if sgt.ts >= nxt:
            gpu.expire(sgt.ts)
            cpu.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        if sgt.op == "+":
            assert gpu.insert(*sgt.as_edge()) == cpu.insert(*sgt.as_edge())
        else:
            assert gpu.delete(*sgt.as_edge()) == cpu.delete(*sgt.as_edge())
    assert torch.equal(gpu.executor.dense_dist().cpu(), cpu.executor.dense_dist())
    assert torch.equal(gpu.executor.dense_adj().cpu(), cpu.executor.dense_adj())
    assert gpu.executor.frontier_stats == cpu.executor.frontier_stats
    assert gpu.executor.adjacency_stats == cpu.executor.adjacency_stats
    st = gpu.executor.frontier_stats
    assert st["fallbacks"] >= 1 and st["cap"] > 2
    b1_runs = b1.maxmin_matmul_fused.launches - launches[0]
    b5_runs = b5.ell_contract_rows.launches - launches[1]
    rounds = gpu.total_rounds - rounds0
    contractions = gpu.executor.ell_contractions_total - contractions0
    assert gpu.executor.ell_contractions_total == cpu.executor.ell_contractions_total
    if adj_layout == "ell":
        # the fallbacks' dense rounds ran in chunks: more launches than rounds
        assert (b1_runs, b5_runs) == (0, contractions) and contractions > rounds
    else:
        assert (b1_runs, b5_runs, contractions) == (rounds, 0, 0)


# (M, C, E, keys): C from 1 to 256, E off the kernel's 4096-column tile
# and not a multiple of 4 (rows start off 16-byte alignment), keys drawn
# uniformly ("random"), crowded with duplicates around the 4096-column tile
# boundaries ("boundary"), or every slot free ("free")
B6_CASES = [(12, 4, 30, "random"), (5, 1, 33, "random"), (9, 16, 257, "random"),
            (7, 8, 40, "random"), (3, 64, 100, "random"), (40, 256, 4097, "random"),
            (17, 128, 2049, "random"), (192, 4, 32768, "random"),
            (9, 64, 8193, "random"), (11, 32, 8194, "random"), (13, 16, 8195, "random"),
            (7, 256, 12291, "boundary"), (6, 1, 8197, "boundary"),
            (5, 64, 4098, "boundary"), (8, 16, 9001, "free"), (3, 256, 4096, "free")]


def _b6_operands(rng, m, c, e, keys):
    idx = rng.integers(0, e, (m, c)).astype(np.int32)
    if keys == "boundary":                       # both sides of each tile edge
        edges = np.arange(4096, e, 4096)
        near = (edges[:, None] + np.arange(-2, 2)[None]).reshape(-1)
        idx = rng.choice(near[(near >= 0) & (near < e)], (m, c)).astype(np.int32)
    idx[:, 1::2] = idx[:, :1]                    # duplicate (stale) keys
    ts = rng.uniform(0.0, 1000.0, (m, c)).astype(np.float32)
    ts[rng.random(ts.shape) < 0.25] = -np.inf    # free slots
    ts[::3] = -np.inf                            # all-free rows
    if keys == "free":
        ts[:] = -np.inf
    return idx, ts


@pytest.mark.parametrize("M,C,E,keys", B6_CASES)
def test_b6_kernel_equals_plain_version(cuda, M, C, E, keys):
    rng = np.random.default_rng(M * 1000 + C + E)
    idx, ts = _b6_operands(rng, M, C, E, keys)
    idx, ts = torch.from_numpy(idx).to(cuda), torch.from_numpy(ts).to(cuda)
    before = b6.rowsparse_gather.launches
    out = b6.rowsparse_gather(idx, ts, E)
    torch.cuda.synchronize()
    assert b6.rowsparse_gather.launches == before + 1
    assert torch.equal(out, rowsparse_gather_ref(idx, ts, E))


def test_b6_refuses_bad_operands(cuda):
    idx = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    ts = torch.zeros((3, 4), device=cuda)
    with pytest.raises(TypeError):
        b6.rowsparse_gather(idx.long(), ts, 8)
    with pytest.raises(TypeError):
        b6.rowsparse_gather(idx, ts.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        b6.rowsparse_gather(idx.t().contiguous().t(), ts.t().contiguous().t(), 8)


def test_row_sparse_engine_on_card_equals_engine_on_cpu(cuda, monkeypatch):
    """frontier="auto" from a tiny capacity over the ELL adjacency and the
    row-sparse dist from dist_cap=2 (table claims, drains, re-packs,
    fallbacks, cone deletes), dense rounds in chunks of 3 transition rows:
    per event and in the final leaves the card equals the CPU, and on the
    card B6 ran once per frontier insert dispatch that did not fall back,
    B5 once per frontier round and once per chunk of a dense round, and B1
    never."""
    monkeypatch.setattr(semiring, "ELL_ROUND_BYTES", SMALL_ROUND_BYTES)
    queries = [("q1", "a2q . c2a*", "arbitrary"),
               ("q2", "(a2q | c2a | c2q)+", "arbitrary")]

    def engine(device):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
            n_slots=16, batch_size=1, frontier="auto", frontier_cap=2,
            adj_layout="ell", ell_cap=2, dist_layout="row_sparse", dist_cap=2,
            device=device)

    gpu, cpu = engine(cuda), engine("cpu")
    stream = with_deletions(so_like(n_vertices=24, n_edges=160, seed=4),
                            ratio=0.05, seed=2)
    launches = (b1.maxmin_matmul_fused.launches, b5.ell_contract_rows.launches,
                b6.rowsparse_gather.launches)
    rounds0, contractions0 = gpu.total_rounds, gpu.executor.ell_contractions_total
    nxt = 2.0
    for sgt in stream:
        if sgt.ts >= nxt:
            gpu.expire(sgt.ts)
            cpu.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        if sgt.op == "+":
            assert gpu.insert(*sgt.as_edge()) == cpu.insert(*sgt.as_edge())
        else:
            assert gpu.delete(*sgt.as_edge()) == cpu.delete(*sgt.as_edge())
    for a, b in zip(gpu.executor.arrays.dist, cpu.executor.arrays.dist):
        assert torch.equal(a.cpu(), b)
    assert gpu.executor.dist_stats == cpu.executor.dist_stats
    assert gpu.executor.frontier_stats == cpu.executor.frontier_stats
    st, dst = gpu.executor.frontier_stats, gpu.executor.dist_stats
    assert st["fallbacks"] >= 1 and dst["repacks"] >= 1 and dst["lost"] == 0
    inserts_kept = ((st["dispatches"] - st["delete_dispatches"])
                    - (st["fallbacks"] - st["delete_fallbacks"]))
    runs = (b1.maxmin_matmul_fused.launches - launches[0],
            b5.ell_contract_rows.launches - launches[1],
            b6.rowsparse_gather.launches - launches[2])
    contractions = gpu.executor.ell_contractions_total - contractions0
    assert runs == (0, contractions, inserts_kept)
    assert contractions > gpu.total_rounds - rounds0
    assert gpu.executor.ell_contractions_total == cpu.executor.ell_contractions_total


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("J,m,k,n", [c for c in CASES if c[0] == 1])
def test_b2_kernel_equals_plain_version(cuda, J, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(_rand_ts(rng, (m, k), dtype)).to(cuda)
    b = torch.from_numpy(_rand_ts(rng, (k, n), dtype)).to(cuda)
    before = (b1.maxmin_matmul.launches, b1.maxmin_matmul_fused.launches)
    out = b1.maxmin_matmul(a, b)
    torch.cuda.synchronize()
    assert (b1.maxmin_matmul.launches, b1.maxmin_matmul_fused.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(out, maxmin_matmul_ref(a, b))


# tests/test_kernels.py: BUCKET_SHAPES (m, k, n, T), plus odd shapes (m=1,
# k or n off the 64 tile and not a multiple of 8, T=1, T past n_levels + 1
# of the defaults) and batched J
BUCKET_CASES = [(1, 16, 16, 16, 4), (1, 128, 128, 128, 8), (1, 70, 200, 90, 3),
                (1, 1, 130, 257, 6), (1, 1, 7, 5, 1), (3, 33, 70, 9, 9),
                (3, 4, 2048, 100, 9), (5, 65, 129, 63, 20), (2, 100, 1, 3, 9)]


def _levels(rng, shape, t):
    """Levels in [0, T + 2] (above T counts T), about half of them 0."""
    x = rng.integers(0, t + 3, shape).astype(np.int32)
    x[rng.random(shape) < 0.5] = 0
    return x


@pytest.mark.parametrize("J,m,k,n,T", BUCKET_CASES)
def test_b3_b4_kernels_equal_plain_versions(cuda, J, m, k, n, T):
    rng = np.random.default_rng(J * 1000 + m + k + n + T)
    a = torch.from_numpy(_levels(rng, (J, m, k), T)).to(cuda)
    b = torch.from_numpy(_levels(rng, (J, k, n), T)).to(cuda)
    a[:, : max(1, m // 5)] = 0                   # all-zero rows
    before = (b3.bucket_maxmin_fused.launches, b3.bucket_maxmin.launches)
    out = b3.bucket_maxmin_fused(a, b, n_levels=T)
    pair = b3.bucket_maxmin(a[0].contiguous(), b[0].contiguous(), n_levels=T)
    torch.cuda.synchronize()
    assert (b3.bucket_maxmin_fused.launches, b3.bucket_maxmin.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, bucket_maxmin_fused_ref(a, b, T))
    assert torch.equal(pair, bucket_maxmin_ref(a[0], b[0], T))


def test_bucket_kernels_refuse_bad_operands(cuda):
    a = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        b3.bucket_maxmin_fused(a.float(), a.float(), n_levels=9)
    with pytest.raises(ValueError, match="contiguous"):
        b3.bucket_maxmin_fused(a.transpose(1, 2), a, n_levels=9)
    with pytest.raises(ValueError, match="n_levels"):
        b3.bucket_maxmin(a[0], a[0], n_levels=128)


# B3/B4 on level operands shaped around the kernel's tiles
# (tests/_torch_levels.py: whole tiles at level 0 in a, b or both, lone
# corner entries, the worst case, the clamp); ragged m, k, n (k % 4 and
# n % 4 not 0: the pre-pass's 4-byte loads), the frontier's skinny
# m in {4, 32}, and k past 128 k tiles (the product lists k tiles 128 at a
# time)
B3_SHAPES = [(2, 300, 260, 270), (1, 64, 128, 128), (3, 4, 1000, 300),
             (2, 32, 1000, 512), (2, 257, 49, 131), (1, 130, 70, 30),
             (1, 40, 8325, 70)]


def _b3_b4_equal_plain(cuda, a_np, b_np, t):
    a, b = torch.from_numpy(a_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    before = (b3.bucket_maxmin_fused.launches, b3.bucket_maxmin.launches)
    out = b3.bucket_maxmin_fused(a, b, n_levels=t)
    pair = b3.bucket_maxmin(a[-1].contiguous(), b[-1].contiguous(), n_levels=t)
    torch.cuda.synchronize()
    assert (b3.bucket_maxmin_fused.launches, b3.bucket_maxmin.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(out, bucket_maxmin_fused_ref(a, b, t))
    assert torch.equal(pair, bucket_maxmin_ref(a[-1], b[-1], t))


@pytest.mark.parametrize("J,m,k,n", B3_SHAPES)
@pytest.mark.parametrize("pattern", LEVEL_PATTERNS)
def test_b3_b4_on_level_patterns(cuda, pattern, J, m, k, n):
    """B3 and B4 (pre-pass and product) equal their plain versions where
    the pre-pass flags whole tiles at level 0 and the product skips k
    tiles and thresholds, and where nothing can be skipped."""
    rng = np.random.default_rng(J * 1000 + m + k + n + len(pattern))
    _b3_b4_equal_plain(cuda, *level_operands(rng, pattern, J, m, k, n, 9), 9)


@pytest.mark.parametrize("T", [0, 1, 9, 127])
@pytest.mark.parametrize("pattern", ["uniform", "corners", "worst", "clamp"])
def test_b3_b4_at_every_threshold_count(cuda, pattern, T):
    rng = np.random.default_rng(T + len(pattern))
    _b3_b4_equal_plain(cuda, *level_operands(rng, pattern, 2, 130, 300, 200, T), T)


def test_b3_on_misaligned_views(cuda):
    """Contiguous operands whose base is not 16-byte aligned (a view one
    element into its storage) take the pre-pass's 4-byte loads; the
    output's base is the allocator's."""
    rng = np.random.default_rng(12)
    a_np, b_np = level_operands(rng, "uniform", 2, 64, 128, 96, 9)
    base_a = torch.zeros(a_np.size + 1, dtype=torch.int32, device=cuda)
    base_b = torch.zeros(b_np.size + 1, dtype=torch.int32, device=cuda)
    base_a[1:] = torch.from_numpy(a_np.ravel()).to(cuda)
    base_b[1:] = torch.from_numpy(b_np.ravel()).to(cuda)
    a, b = base_a[1:].view(a_np.shape), base_b[1:].view(b_np.shape)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    out = b3.bucket_maxmin_fused(a, b, n_levels=9)
    torch.cuda.synchronize()
    assert torch.equal(out, bucket_maxmin_fused_ref(a, b, 9))


@pytest.mark.parametrize("J,M,U,E", B5_CASES)
def test_b5_int32_entry_equals_plain_version(cuda, J, M, U, E):
    rng = np.random.default_rng(J * 1000 + M + U + E + 1)
    d, idx, ts = _ell_operands(rng, J, M, U, E, cuda)
    d, ts = (torch.where(x > float("-inf"), x / 100.0 + 1.0, 0.0).to(torch.int32)
             for x in (d, ts))                   # levels 1..10, free slots 0
    before = b5.ell_gather_contract.launches
    out = b5.ell_gather_contract(d, idx, ts)
    torch.cuda.synchronize()
    assert b5.ell_gather_contract.launches == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, ell_gather_contract_ref(d, idx, ts, zero=0))
    with pytest.raises(TypeError):
        b5.ell_gather_contract(d, idx, ts.float())   # one element type


@pytest.mark.parametrize("layout", [dict(), dict(frontier="auto", frontier_cap=2),
                                    dict(frontier="auto", frontier_cap=2,
                                         adj_layout="ell", ell_cap=2),
                                    dict(frontier="auto", frontier_cap=2,
                                         adj_layout="ell", ell_cap=2,
                                         dist_layout="row_sparse", dist_cap=2)])
def test_bucket_engine_on_card_equals_engine_on_cpu(cuda, layout):
    """The bucket backend on the card (B3, or B5 on int32 with the ELL
    adjacency, and B6's raw float32 gather with the row-sparse dist)
    equals its plain versions on the CPU per event and in the stored
    float32 dist."""
    queries = [("q1", "a2q . c2a*", "arbitrary"),
               ("q2", "(a2q | c2a | c2q)+", "arbitrary")]

    def engine(device):
        return BatchedDenseRPQEngine(
            [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in queries],
            n_slots=16, batch_size=1, backend=BucketBackend(8), device=device,
            **layout)

    gpu, cpu = engine(cuda), engine("cpu")
    stream = with_deletions(so_like(n_vertices=24, n_edges=120, seed=4),
                            ratio=0.05, seed=2)
    launches = (b3.bucket_maxmin_fused.launches, b5.ell_contract_rows.launches,
                b1.maxmin_matmul_fused.launches)
    rounds0, contractions0 = gpu.total_rounds, gpu.executor.ell_contractions_total
    nxt = 2.0
    for sgt in stream:
        if sgt.ts >= nxt:
            gpu.expire(sgt.ts)
            cpu.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        if sgt.op == "+":
            assert gpu.insert(*sgt.as_edge()) == cpu.insert(*sgt.as_edge())
        else:
            assert gpu.delete(*sgt.as_edge()) == cpu.delete(*sgt.as_edge())
    assert torch.equal(gpu.executor.dense_dist().cpu(), cpu.executor.dense_dist())
    runs = (b3.bucket_maxmin_fused.launches - launches[0],
            b5.ell_contract_rows.launches - launches[1],
            b1.maxmin_matmul_fused.launches - launches[2])
    rounds = gpu.total_rounds - rounds0
    contractions = gpu.executor.ell_contractions_total - contractions0
    ell = layout.get("adj_layout") == "ell"
    # one B5 launch per frontier round and per J chunk of a dense round (one
    # chunk at this size)
    assert runs == ((0, contractions, 0) if ell else (rounds, 0, 0))
    assert contractions == (rounds if ell else 0)


def test_legacy_closure_on_card_equals_plain(cuda):
    """The legacy single-query closure: the "cuda" backend (B2) equals
    "plain" and the bucket backend (B4) its plain versions, on the card;
    one launch per transition per round."""
    rng = np.random.default_rng(3)
    dfa = compile_query("a . b* . c")
    tt = TransitionTable.from_dfa(dfa, device=cuda)
    n = 130
    adj = torch.from_numpy(_rand_ts(rng, (dfa.n_labels, n, n), np.float32)).to(cuda)
    adj[adj < 900.0] = float("-inf")             # a sparse graph: several rounds
    dist = torch.full((n, n, dfa.k), float("-inf"), device=cuda)
    n_trans = tt.src.shape[0]
    before = b1.maxmin_matmul.launches
    out, rounds = closure(dist, adj, tt, "cuda")
    torch.cuda.synchronize()
    assert b1.maxmin_matmul.launches - before == n_trans * rounds
    assert torch.equal(out, closure(dist, adj, tt, "plain")[0])
    bucket = BucketBackend(8)
    now, w = torch.tensor(1000.0, device=cuda), torch.tensor(120.0, device=cuda)
    d_l, a_l = bucket.prepare_state(dist, adj, now, w)
    before = b3.bucket_maxmin.launches
    out_l, rounds_l = closure(d_l, a_l, tt, bucket)
    torch.cuda.synchronize()
    assert b3.bucket_maxmin.launches - before == n_trans * rounds_l
    assert torch.equal(out_l, closure(d_l, a_l, tt, BucketBackend(8, use_kernels=False))[0])


# -- checkpoints and supervision on the card ---------------------------------------

SERVICE_LAYOUTS = [dict(), dict(frontier="on", frontier_cap=16, adj_layout="ell",
                                ell_cap=6, dist_layout="row_sparse", dist_cap=24)]


def _ckpt_service(device, **layout):
    from repro_torch.streaming.service import PersistentQueryService

    svc = PersistentQueryService(window=20.0, slide=2.0, device=device, **layout)
    svc.register("d_arb", "a2q . c2a*", n_slots=48)
    svc.register("d_plus", "(a2q | c2a)+", n_slots=48)
    svc.register("d_smp", "(a2q | c2a | c2q)*", path_semantics="simple", n_slots=48)
    svc.register("r_arb", "a2q . c2a*", engine="reference")
    return svc


def _ckpt_tuples():
    return list(with_deletions(so_like(24, 110, seed=13), ratio=0.04, seed=7))


def _executor_tensors(x):
    """Every tensor of the executor's arrays (through the ELL and
    row-sparse leaves)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _executor_tensors(v)]
    return []


def _snapshot_then_restore(writer_device, reader_device, layout):
    import tempfile

    from repro_torch.streaming.stream import Stream

    tuples = _ckpt_tuples()
    half = len(tuples) // 2
    writer = _ckpt_service(writer_device, **layout)
    writer.ingest(Stream(tuples[:half]))
    with tempfile.TemporaryDirectory() as d:
        writer.snapshot(d, step=half)
        tail = writer.ingest(Stream(tuples[half:]))
        reader = _ckpt_service(reader_device, **layout)
        assert reader.restore(d) == half
    tensors = _executor_tensors(reader.queries["d_arb"].executor.arrays)
    assert tensors and {t.device.type for t in tensors} == {torch.device(reader_device).type}
    tail2 = reader.ingest(Stream(tuples[half:]))
    for name in ("d_arb", "d_plus", "d_smp", "r_arb"):
        assert tail2[name] == tail[name], name
        assert tail2.invalidated[name] == tail.invalidated[name], name
        assert reader.results(name) == writer.results(name), name


@pytest.mark.parametrize("layout", SERVICE_LAYOUTS)
def test_snapshot_on_card_restores_on_card(cuda, layout):
    _snapshot_then_restore(cuda, cuda, layout)


@pytest.mark.parametrize("direction", ["card-to-cpu", "cpu-to-card"])
def test_checkpoint_crosses_card_and_cpu(cuda, direction):
    devices = (cuda, "cpu") if direction == "card-to-cpu" else ("cpu", cuda)
    _snapshot_then_restore(*devices, SERVICE_LAYOUTS[1])
    _snapshot_then_restore(*devices, SERVICE_LAYOUTS[0])


@pytest.mark.parametrize("layout", SERVICE_LAYOUTS)
def test_crash_recovery_identity_on_card(cuda, layout):
    """Every fault point of tests/test_torch_supervisor.py on the card: the
    chaos run's streams equal the clean run's on the card and on the CPU."""
    import tempfile

    from repro_torch.streaming.supervisor import FaultPlan, ServiceSupervisor

    plan_kw = dict(crash_before_dispatch=[3], crash_after_dispatch=[7],
                   crash_during_replay=[9],
                   crash_mid_snapshot={1: "shards", 2: "manifest", 3: "rename"},
                   transient_errors={6: 2})

    def run(device, plan=None):
        def make(**extra):
            return _ckpt_service(device, **{**layout, **extra})

        with tempfile.TemporaryDirectory() as d:
            sup = ServiceSupervisor(make, d, batch_events=8, ckpt_every=4,
                                    fault_plan=plan)
            final = sup.run(_ckpt_tuples())
            tensors = _executor_tensors(sup.service.queries["d_arb"].executor.arrays)
            assert {t.device.type for t in tensors} == {torch.device(device).type}
            return final, sup.result_stream(), sup.invalidation_stream(), sup

    clean_cpu = run("cpu")[:3]
    assert run(cuda)[:3] == clean_cpu
    plan = FaultPlan(**plan_kw)
    *chaos, sup = run(cuda, plan)
    assert plan.exhausted and sup.restarts >= 4 and sup.recoveries
    assert tuple(chaos) == clean_cpu


# -- the mesh executor on the card -------------------------------------------------

MESH_CONFIGS = {"dense": dict(),
                "sparse": dict(frontier="auto", frontier_cap=2, adj_layout="ell",
                               ell_cap=2, dist_layout="row_sparse", dist_cap=2),
                "bucket": dict(backend=BucketBackend(8))}


def _mesh_state_tensors(ex):
    """Every tensor the mesh holds between dispatches: its grids' blocks,
    the adjacency's blocks at rest (or every ELL replica's leaves), each
    lane shard's row-sparse leaves with the overflow table, and the clock."""
    a = ex._arrays
    out = _executor_tensors(a.now)
    out += ([t for held in a.adj.pieces.values() for t in held.values()]
            if hasattr(a.adj, "pieces") else
            [t for rep in ex._ell_reps.values() for t in _executor_tensors(rep)])
    for part in (a.dist, a.emitted):
        out += ([b for row in part.blocks for b in row] if hasattr(part, "blocks")
                else [*part.idx, *part.ts, *_executor_tensors(part.table)])
    return out


@pytest.mark.parametrize("cards", ["one", "every"])
@pytest.mark.parametrize("grid", [(4, 1), (4, 2)], ids=["4x1", "2x2"])
@pytest.mark.parametrize("config", sorted(MESH_CONFIGS))
def test_mesh_on_card_equals_local_on_card(cuda, config, grid, cards):
    """The mesh over ``["cuda:0"] * 4`` (``cards="one"``), or over four
    distinct cards (``"every"``: the peers' fold and the result joins copy
    across cards; skipped on fewer than four), equals the local executor
    on the first card per event; B1 (or B3 with the bucket backend)
    launches once per shard-round per model peer, B5 and B6 never; no
    state tensor on the CPU."""
    from repro_torch.distributed.executor import MeshExecutor

    k, model_axis = grid
    devices = [f"cuda:{torch.cuda.current_device()}"] * k
    if cards == "every":
        if torch.cuda.device_count() < k:
            pytest.skip(f"needs {k} CUDA cards")
        devices = [f"cuda:{i}" for i in range(k)]
    opts = dict(MESH_CONFIGS[config])
    backend = opts.pop("backend", None)
    specs = [RegisteredQuery(n, compile_query(e), 20.0, s) for n, e, s in
             [("q1", "a2q . c2a*", "arbitrary"), ("q2", "(a2q | c2a | c2q)+", "arbitrary"),
              ("q3", "a2q . c2a* . c2q*", "simple")]]
    local = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1, backend=backend,
                                  device=cuda, **opts)
    ex = MeshExecutor(devices, model_axis=model_axis, backend=backend, **opts)
    mesh = BatchedDenseRPQEngine(specs, n_slots=16, batch_size=1, executor=ex)
    kernels = (b1.maxmin_matmul_fused, b3.bucket_maxmin_fused,
               b5.ell_contract_rows, b6.rowsparse_gather)
    mesh_launches = [0, 0, 0, 0]
    nxt = 2.0
    for sgt in with_deletions(so_like(n_vertices=24, n_edges=120, seed=4),
                              ratio=0.05, seed=2):
        if sgt.ts >= nxt:
            local.expire(sgt.ts)
            mesh.expire(sgt.ts)
            while nxt <= sgt.ts:
                nxt += 2.0
        fn = "insert" if sgt.op == "+" else "delete"
        want = getattr(local, fn)(*sgt.as_edge())
        before = [kern.launches for kern in kernels]
        got = getattr(mesh, fn)(*sgt.as_edge())
        torch.cuda.synchronize()
        mesh_launches = [m + kern.launches - b
                         for m, kern, b in zip(mesh_launches, kernels, before)]
        assert got[:3] == want[:3], sgt
    if "frontier" not in opts:
        # a frontier delete and a dense fallback agree above the window
        # threshold only, and the mesh falls back per shard
        md = mesh.executor.dense_dist()   # lanes padded to the shard count
        assert torch.equal(md[:local.q_cap], local.executor.dense_dist())
        assert not bool((md[local.q_cap:] > float("-inf")).any())
    per_round = ex.n_model * ex.shard_rounds_total
    assert mesh_launches == ([0, per_round, 0, 0] if config == "bucket"
                             else [per_round, 0, 0, 0])
    assert ex.shard_rounds_total + ex.skipped_shard_rounds_total == \
        ex.n_shards * ex.sync_rounds_total
    tensors = _mesh_state_tensors(ex)
    assert tensors and {t.device.type for t in tensors} == {"cuda"}
    assert {t.device for t in tensors} == {torch.device(d) for d in devices}


# -- the LM serving path (repro_torch.models) ------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-370m", "dbrx-132b"])
def test_lm_serving_on_card_equals_cpu(cuda, arch):
    """A reduced dense, SSD and MoE config (float32, weights from a seeded
    CPU generator copied to the card): forward logits and aux, prefill and
    six teacher-forced decode steps on the card within 1e-4 x (1 + |ref|)
    of the CPU's, and the MoE layers' chosen experts equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE, route
    from repro_torch.models.transformer import Model

    assert not torch.backends.cuda.matmul.allow_tf32   # IEEE float32 matmuls
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)))

    def run(model, device):
        seen = []
        hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0])))
                 for m in model.modules() if isinstance(m, MoE)]
        tk = tokens.to(device)
        with torch.no_grad():
            logits, aux = model.forward(tk)
        out = [logits, aux]
        step, caches = model.prefill(tk[:, :18], max_len=24)
        out.append(step)
        for i in range(18, 24):
            step, caches = model.decode_step(tk[:, i:i + 1], caches)
            out.append(step)
        for h in hooks:
            h.remove()
        experts = [route(mod, x.reshape(-1, x.shape[-1]), cfg.experts_per_token,
                         cfg.capacity_factor).expert_idx.cpu() for mod, x in seen]
        return [t.float().cpu() for t in out], experts

    (ref, ref_experts), (got, got_experts) = run(cpu, "cpu"), run(card, cuda)
    for r, g in zip(ref, got):
        assert ((g - r).abs() <= 1e-4 * (1 + r.abs())).all(), float((g - r).abs().max())
    assert len(got_experts) == len(ref_experts) == (8 * cfg.n_layers if cfg.n_experts else 0)
    assert all(torch.equal(a, b) for a, b in zip(got_experts, ref_experts))


# -- LM training (repro_torch.launch.train, repro_torch.optim) --------------------


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-370m", "dbrx-132b"])
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """A reduced dense, SSD and MoE config (float32, weights from a seeded
    CPU generator copied to the card): one train step at ``microbatches`` 1
    and at 2 (bfloat16 accumulation) from zero moments on the card and on
    the CPU. Loss, grad norm, m and v within 1e-4 x (1 + |CPU's|), the lr
    within 1e-6 relative; every parameter within 1e-5 x (1 + |CPU's|),
    except where the step's clipped gradient lies within 1e-4 (x the clip
    scale) of zero: there Adam's first update, ~lr * sign(g), may flip, so
    such an entry may differ by 2 lr more."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw

    assert not torch.backends.cuda.matmul.allow_tf32   # IEEE float32 matmuls
    opt = AdamWConfig(lr_peak=3e-3, warmup_steps=10, total_steps=10)

    def close(a, b, tol=1e-4):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        return bool(((a - b).abs() <= tol * (1 + b.abs())).all())

    for M in (1, 2):
        cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=M)
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
        card = Model(cfg, device=cuda)
        card.load_state_dict(cpu.state_dict())
        tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 32)))
        out = []
        for model, device in ((cpu, "cpu"), (card, cuda)):
            state = init_adamw(opt, model)
            out.append(make_train_step(model, opt)(model, state, {"tokens": tokens.to(device)}))
        (rm, rs, rmet), (gm, gs, gmet) = out
        assert close(gmet["loss"], rmet["loss"]) and close(gmet["grad_norm"], rmet["grad_norm"])
        lr = float(rmet["lr"])
        assert abs(float(gmet["lr"]) - lr) <= 1e-6 * lr and int(gs.step) == int(rs.step) == 1
        scale = min(1.0, opt.clip_norm / (float(rmet["grad_norm"]) + 1e-9))
        ref_params = dict(rm.named_parameters())
        for k, p in gm.named_parameters():
            assert close(gs.m[k], rs.m[k]) and close(gs.v[k], rs.v[k]), (M, k)
            a, b = p.detach().cpu(), ref_params[k].detach()
            err, tight = (a - b).abs(), 1e-5 * (1 + b.abs())
            near_zero = rs.m[k].abs() <= (1 - opt.b1) * 1e-4 * scale
            assert ((err <= tight) | (near_zero & (err <= tight + 2 * lr))).all(), (M, k)


@pytest.mark.parametrize("kind,batch", [("train", 4), ("prefill", 4), ("decode", 4),
                                        ("decode", 1)], ids=["train", "prefill", "decode",
                                                             "long-decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "dbrx-132b", "mamba2-370m",
                                  "jamba-1.5-large-398b", "paligemma-3b", "musicgen-large"])
def test_lm_dryrun_share_on_card_equals_cpu(cuda, arch, kind, batch):
    """The LM dry run's share of device (0, 0) on a 2x2 grid (one reduced
    config a family, 1 and 2 periods, float32, the same seeded weights and
    inputs): its logits and caches, or its loss and gradients, on the card
    within 1e-4 x (1 + max |CPU's|) of the CPU's; batch 1 is the
    sequence-sharded decode."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as dr

    assert not torch.backends.cuda.matmul.allow_tf32   # IEEE float32 matmuls
    cfg, shape, grid, ss = dr.cell_config(get_config(arch).reduced(),
                                          ShapeConfig(kind, 16, batch, kind),
                                          grid=((2, 2), ("data", "model")))
    for n_periods in (1, 2):
        host = dr.LMShare(cfg, shape, grid, ss, n_periods * cfg.period,
                          torch.Generator().manual_seed(n_periods))
        card = host.to(cuda)
        assert card.model.device.type == "cuda"
        assert dr.max_scaled_err(card.run(), host.run()) <= 1e-4, n_periods
