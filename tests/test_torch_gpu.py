"""Tests that need the CUDA card: kernel B1 against its plain version on
the card, and the port's engine on the card against itself on the CPU.

Marked ``gpu``; each skips (from the ``cuda`` fixture, never at import or
collection) where there is no card. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.kernels.maxmin import maxmin as b1
from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref
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
