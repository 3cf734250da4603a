"""Kernels B1 and B5 in the port: their plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode) and references, bit for bit
(B1 on dense and on block-sparse operands).

The same numpy inputs, made from a seed, go through both packages. Max and
min never reassociate, so the tolerance is 0 (``assert_array_equal``). On
the CPU the port's wrapper takes the plain version; the CUDA kernel itself
is held against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.backend import JnpBackend
from repro.core.sparse_adj import EllAdjacency as JaxEll
from repro.kernels.ell.ell import ell_gather_contract_fused as jax_ell_fused
from repro.kernels.ell.ref import ell_gather_contract_ref as jax_ell_ref
from repro.kernels.maxmin.maxmin import maxmin_matmul_fused as jax_fused
from repro.kernels.maxmin.ref import maxmin_matmul_naive as jax_naive
from repro_torch.core.contraction import resolve_backend
from repro_torch.core.sparse_adj import from_numpy as ell_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels.ell import ell as b5
from repro_torch.kernels.ell.ref import ell_gather_contract_naive, ell_gather_contract_ref
from repro_torch.kernels.maxmin import maxmin as b1
from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref, maxmin_matmul_naive

# tests/test_kernels.py: SHAPES (m, k, n), run here as J=1, and ODD_SHAPES
SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 200), (1, 256, 33),
          (257, 1, 129), (64, 512, 64)]
ODD_SHAPES = [(3, 4, 40, 40), (5, 16, 33, 33), (2, 1, 7, 19), (7, 23, 5, 64),
              (1, 130, 70, 30)]
CASES = [(1, m, k, n) for (m, k, n) in SHAPES] + ODD_SHAPES


def _rand_ts(rng, shape, dtype, density=0.7):
    x = rng.uniform(0.0, 1000.0, shape).astype(dtype)
    x[rng.random(shape) > density] = -np.inf
    return x


def _operands(j, m, k, n, dtype):
    rng = np.random.default_rng(j * 7919 + m * 1000 + k * 31 + n)
    a = _rand_ts(rng, (j, m, k), dtype)
    b = _rand_ts(rng, (j, k, n), dtype)
    a[:, : max(1, m // 5)] = -np.inf          # all -inf rows
    b[:, :, : max(1, n // 6)] = -np.inf       # all -inf columns
    return a, b


def _block_sparse(a, b, seed):
    """Copies of a and b with most (8, 4) tiles of a and (4, 8) tiles of b
    all -inf, the regime of the main path's operands, where the kernel
    skips k steps whose operand tile is all -inf."""
    rng = np.random.default_rng(seed)
    a, b = a.copy(), b.copy()
    for x, (tr, tc) in ((a, (8, 4)), (b, (4, 8))):
        _, r, c = x.shape
        for r0 in range(0, r, tr):
            for c0 in range(0, c, tc):
                if rng.random() < 0.7:
                    x[:, r0:r0 + tr, c0:c0 + tc] = -np.inf
    return a, b


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("J,m,k,n", CASES)
def test_plain_b1_matches_jax_fused_kernel(J, m, k, n, dtype):
    dense = _operands(J, m, k, n, dtype)
    for a, b in (dense, _block_sparse(*dense, seed=J + m + k + n)):
        ref = np.asarray(jax_fused(jnp.asarray(a), jnp.asarray(b), interpret=True))
        out = maxmin_matmul_fused_ref(torch.from_numpy(a), torch.from_numpy(b))
        assert out.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(out.numpy(), ref)
        # the wrapper on a CPU tensor is the plain version, and launches nothing
        before = b1.maxmin_matmul_fused.launches
        wrapped = b1.maxmin_matmul_fused(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(wrapped.numpy(), ref)
        assert b1.maxmin_matmul_fused.launches == before


@pytest.mark.parametrize("J,m,k,n", ODD_SHAPES)
def test_naive_forms_match(J, m, k, n):
    a, b = _operands(J, m, k, n, np.float32)
    ref = np.stack([np.asarray(jax_naive(jnp.asarray(a[j]), jnp.asarray(b[j])))
                    for j in range(J)])
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(maxmin_matmul_naive(ta, tb).numpy(), ref)
    np.testing.assert_array_equal(
        maxmin_matmul_fused_ref(ta, tb, chunk=3).numpy(), ref)


def test_all_neg_inf_operands_give_neg_inf():
    a = torch.full((2, 3, 4), float("-inf"))
    b = torch.full((2, 4, 5), float("-inf"))
    out = b1.maxmin_matmul_fused(a, b)
    assert out.shape == (2, 3, 5) and bool(torch.isneginf(out).all())


def test_wrapper_rejects_bad_operands():
    a = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        b1.maxmin_matmul_fused(a, torch.zeros((2, 5, 6)))
    with pytest.raises(ValueError):
        b1.maxmin_matmul_fused(a[0], torch.zeros((4, 6)))
    with pytest.raises(ValueError):
        b1.maxmin_matmul_fused(a, torch.zeros((2, 4, 6), dtype=torch.float16))


def test_library_path_is_keyed_by_source_hash():
    p = build.library_path("maxmin")
    assert p.parent == build.BUILD_DIR
    assert p.name.startswith("libmaxmin_") and p.suffix == ".so"
    assert p == build.library_path("maxmin")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS


# -- kernel B5: the ELL gather-contract ---------------------------------------


# (J, M, U, E): m=1, u not a multiple of 8, E=1, and the (J, F, N, E) form
# of a frontier round; every case has all-free rows and duplicate
# destinations within a row (_ell_operands)
B5_CASES = [(2, 5, 12, 3), (1, 1, 9, 1), (3, 7, 13, 2), (2, 16, 33, 4),
            (1, 20, 40, 8), (4, 4, 24, 2)]


def _ell_operands(j, m, u, e, seed=0):
    rng = np.random.default_rng(seed + j * 1000 + m * 100 + u * 10 + e)
    d = np.where(rng.random((j, m, u)) < 0.4,
                 rng.integers(1, 40, (j, m, u)).astype(np.float32), -np.inf)
    idx = rng.integers(0, u, (j, u, e)).astype(np.int32)
    ts = np.where(rng.random((j, u, e)) < 0.5,
                  rng.integers(1, 40, (j, u, e)).astype(np.float32), -np.inf)
    ts[:, : max(1, u // 6)] = -np.inf          # all-free rows
    idx[:, :, 0] = idx[:, :, -1]               # duplicate destinations
    return d.astype(np.float32), idx, ts.astype(np.float32)


@pytest.mark.parametrize("J,M,U,E", B5_CASES)
def test_plain_b5_matches_jax_kernel_and_ref(J, M, U, E):
    d, idx, ts = _ell_operands(J, M, U, E)
    ref = np.asarray(jax_ell_fused(jnp.asarray(d), jnp.asarray(idx),
                                   jnp.asarray(ts), interpret=True))
    for j in range(J):
        np.testing.assert_array_equal(
            ref[j], np.asarray(jax_ell_ref(jnp.asarray(d[j]), jnp.asarray(idx[j]),
                                           jnp.asarray(ts[j]))))
    td, ti, tt = torch.from_numpy(d), torch.from_numpy(idx), torch.from_numpy(ts)
    np.testing.assert_array_equal(ell_gather_contract_ref(td, ti, tt).numpy(), ref)
    np.testing.assert_array_equal(
        ell_gather_contract_ref(td, ti, tt, u_chunk=5).numpy(), ref)
    np.testing.assert_array_equal(ell_gather_contract_naive(td, ti, tt).numpy(), ref)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = b5.ell_gather_contract.launches
    np.testing.assert_array_equal(b5.ell_gather_contract(td, ti, tt).numpy(), ref)
    assert b5.ell_gather_contract.launches == before


@pytest.mark.parametrize("seed", range(3))
def test_contract_rows_ell_with_spill_ring(seed):
    """The ELL contraction with a live spill ring (entries on every label,
    free entries, a ring copy of a row-resident edge) against
    JnpBackend.contract_rows_ell, on both port backends."""
    rng = np.random.default_rng(seed)
    l, n, e, s, j, m = 3, 11, 2, 8, 5, 6
    idx = rng.integers(0, n, (l, n, e)).astype(np.int32)
    ts = np.where(rng.random((l, n, e)) < 0.6,
                  rng.integers(1, 40, (l, n, e)).astype(np.float32), -np.inf)
    ssrc, sdst = rng.integers(0, n, (s,)), rng.integers(0, n, (s,))
    slab = rng.integers(0, l, (s,))
    sts = np.where(rng.random(s) < 0.75,
                   rng.integers(1, 40, (s,)).astype(np.float32), -np.inf)
    ssrc[0], sdst[0], slab[0] = 0, idx[0, 0, 0], 0   # ring copy of a row edge
    leaves = (idx, ts.astype(np.float32), ssrc.astype(np.int32),
              sdst.astype(np.int32), slab.astype(np.int32),
              sts.astype(np.float32), np.int32(6))
    d = np.where(rng.random((j, m, n)) < 0.5,
                 rng.integers(1, 40, (j, m, n)).astype(np.float32), -np.inf)
    d = d.astype(np.float32)
    labs = rng.integers(0, l, (j,))
    ref = np.asarray(JnpBackend().contract_rows_ell(
        jnp.asarray(d), JaxEll(*[jnp.asarray(x) for x in leaves]),
        jnp.asarray(labs)))
    ell = ell_from_numpy(JaxEll(*leaves), "cpu")
    for name in ("plain", "cuda"):
        out = resolve_backend(name).contract_rows_ell(
            torch.from_numpy(d), ell, torch.from_numpy(labs))
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=name)


def test_b5_wrapper_rejects_bad_operands():
    d = torch.zeros((2, 3, 4))
    idx = torch.zeros((2, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        b5.ell_gather_contract(d, idx[:, :3], torch.zeros((2, 3, 2)))
    with pytest.raises(ValueError):
        b5.ell_gather_contract(d[0], idx[0], torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        b5.ell_gather_contract(d, idx, torch.zeros((2, 4, 3)))


def test_all_kernels_build_from_their_own_sources():
    for name in ("maxmin", "ell"):
        p = build.library_path(name)
        assert p.name.startswith(f"lib{name}_") and p.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").is_file()
    assert build.library_path("ell") != build.library_path("maxmin")
