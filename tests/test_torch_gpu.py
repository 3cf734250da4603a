"""Tests that need the CUDA card: kernels B1-B6 against their plain
versions on the card (B5 on float32 timestamps and on int32 levels), and
the port's engine on the card against itself on the CPU (dense and
row-sparse dist, the float and the bucket backend, and the legacy
single-query closure).

Marked ``gpu``; each skips (from the ``cuda`` fixture, never at import or
collection) where there is no card. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.contraction import BucketBackend, resolve_backend
from repro_torch.core.semiring import TransitionTable, closure
from repro_torch.core.sparse_adj import ell_insert, pack_ell_dense
from repro_torch.kernels.bucket import bucket as b3
from repro_torch.kernels.bucket.ref import bucket_maxmin_fused_ref, bucket_maxmin_ref
from repro_torch.kernels.ell import ell as b5
from repro_torch.kernels.ell.ref import ell_gather_contract_ref
from repro_torch.kernels.maxmin import maxmin as b1
from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref, maxmin_matmul_ref
from repro_torch.kernels.rowsparse import rowsparse as b6
from repro_torch.kernels.rowsparse.ref import rowsparse_gather_ref
from repro_torch.streaming.generators import so_like, with_deletions

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


# tests/test_torch_kernels.py: B5_CASES (J, M, U, E)
B5_CASES = [(2, 5, 12, 3), (1, 1, 9, 1), (3, 7, 13, 2), (4, 16, 33, 4),
            (1, 130, 257, 8), (48, 4, 2048, 2), (6, 300, 700, 5)]


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


def test_b5_with_a_full_spill_ring(cuda):
    """contract_rows_ell on the card with every ring entry live: kernel B5
    plus the spill fold equal the plain backend on the same inputs."""
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
    before = b5.ell_gather_contract.launches
    out = resolve_backend("cuda").contract_rows_ell(d, ell, labs)
    torch.cuda.synchronize()
    assert b5.ell_gather_contract.launches == before + 1
    assert torch.equal(out, resolve_backend("plain").contract_rows_ell(d, ell, labs))


@pytest.mark.parametrize("adj_layout", ["ell", "dense"])
def test_frontier_engine_on_card_equals_engine_on_cpu(cuda, adj_layout):
    """frontier="auto" from a tiny capacity (fallbacks, growth, cone
    deletes) and, for ELL, a tiny degree capacity (rows spill into the
    ring): per event and in the end state, the card equals the CPU, and on
    the card
    the ELL path launches B5 once per round and B1 never."""
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
    launches = (b1.maxmin_matmul_fused.launches, b5.ell_gather_contract.launches)
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
    b5_runs = b5.ell_gather_contract.launches - launches[1]
    if adj_layout == "ell":
        assert (b1_runs, b5_runs) == (0, gpu.total_rounds)
    else:
        assert (b1_runs, b5_runs) == (gpu.total_rounds, 0)


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


def test_row_sparse_engine_on_card_equals_engine_on_cpu(cuda):
    """frontier="auto" from a tiny capacity over the ELL adjacency and the
    row-sparse dist from dist_cap=2 (table claims, drains, re-packs,
    fallbacks, cone deletes): per event and in the final leaves the card
    equals the CPU, and on the card B6 ran once per frontier insert
    dispatch that did not fall back, B5 once per round and B1 never."""
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
    launches = (b1.maxmin_matmul_fused.launches, b5.ell_gather_contract.launches,
                b6.rowsparse_gather.launches)
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
            b5.ell_gather_contract.launches - launches[1],
            b6.rowsparse_gather.launches - launches[2])
    assert runs == (0, gpu.total_rounds, inserts_kept)


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
    launches = (b3.bucket_maxmin_fused.launches, b5.ell_gather_contract.launches,
                b1.maxmin_matmul_fused.launches)
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
            b5.ell_gather_contract.launches - launches[1],
            b1.maxmin_matmul_fused.launches - launches[2])
    ell = layout.get("adj_layout") == "ell"
    assert runs == ((0, gpu.total_rounds, 0) if ell else (gpu.total_rounds, 0, 0))


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
