"""Kernel B1 in the port: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and naive oracle, bit for bit.

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

from repro.kernels.maxmin.maxmin import maxmin_matmul_fused as jax_fused
from repro.kernels.maxmin.ref import maxmin_matmul_naive as jax_naive
from repro_torch.kernels import build
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


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("J,m,k,n", CASES)
def test_plain_b1_matches_jax_fused_kernel(J, m, k, n, dtype):
    a, b = _operands(J, m, k, n, dtype)
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
