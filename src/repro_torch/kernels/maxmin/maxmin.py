"""Kernels B1 and B2's wrappers: the (max, min) product.

    out[j] = max_k min(a[j], b[j])    a (J, m, k), b (J, k, n) -> (J, m, n)

``maxmin_matmul_fused`` (B1) is the counterpart of
``repro.kernels.maxmin.maxmin.maxmin_matmul_fused``; ``maxmin_matmul``
(B2) of the single-pair ``maxmin_matmul``, (m, k) x (k, n) -> (m, n),
the same kernel launched with J = 1 through its own entry. On a CUDA
tensor each launches the hand-written Hopper kernel in
``repro_torch/csrc/maxmin.cu`` (built by nvcc at first use) or raises;
each takes the plain PyTorch version only for tensors that lie on the
CPU. There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import maxmin_matmul_fused_ref, maxmin_matmul_ref

#: the port's Hopper tile table, one entry so far: BM=128 names, to the CUDA
#: source's ``dispatch``, a 128 x 128 output tile with an 8 x 8 register
#: block per thread, for the dense round's square (N, N) slabs. It is exact
#: for every m, k, n >= 1 (-inf fills the ragged edges); a tile for skinny
#: slabs belongs with the frontier slice (ROADMAP B1).
_TILE_BM = 128

_FUNCS = {torch.float32: "maxmin_fused_f32", torch.float16: "maxmin_fused_f16"}
_PAIR_FUNCS = {torch.float32: "maxmin_f32", torch.float16: "maxmin_f16"}


def _kernel(dtype: torch.dtype, single_pair: bool = False):
    lib = load("maxmin")
    fn = getattr(lib, (_PAIR_FUNCS if single_pair else _FUNCS)[dtype])
    n_ints = 4 if single_pair else 5       # (J,) m, k, n, bm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_card(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """Raise on what the kernel does not take (device, type, layout)."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in _FUNCS:
        raise TypeError(f"kernel {what} takes float32 or float16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"kernel {what} takes contiguous operands")


def _launch(fn, a, *args) -> None:
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"maxmin kernel launch failed: CUDA error {err}")


def maxmin_matmul_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused batched (max, min) product, one kernel launch for all J rows.

    ``maxmin_matmul_fused.launches`` counts the kernel launches (plain
    int); CPU calls and empty problems launch nothing and count nothing."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"expected 3-D operands, got {tuple(a.shape)} x {tuple(b.shape)}")
    j, m, k = a.shape
    j2, k2, n = b.shape
    if (j, k) != (j2, k2):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"operands differ: {a.dtype}/{a.device} vs {b.dtype}/{b.device}")
    if a.device.type == "cpu":
        return maxmin_matmul_fused_ref(a, b)
    _check_card(a, b, "B1")
    if j > 65535:
        raise ValueError(f"J={j} exceeds the grid's z extent (65535)")
    if j == 0 or m == 0 or n == 0 or k == 0:
        return torch.full((j, m, n), float("-inf"), dtype=a.dtype, device=a.device)
    out = torch.empty((j, m, n), dtype=a.dtype, device=a.device)
    _launch(_kernel(a.dtype), a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            j, m, k, n, _TILE_BM)
    maxmin_matmul_fused.launches += 1
    return out


maxmin_matmul_fused.launches = 0


def maxmin_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel B2: the single-pair (max, min) product (m, k) x (k, n) ->
    (m, n), B1's kernel launched with J = 1 (the legacy single-query
    round's contraction, one launch per transition).

    ``maxmin_matmul.launches`` counts the kernel launches (plain int);
    CPU calls and empty problems launch nothing and count nothing."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"operands differ: {a.dtype}/{a.device} vs {b.dtype}/{b.device}")
    if a.device.type == "cpu":
        return maxmin_matmul_ref(a, b)
    _check_card(a, b, "B2")
    if m == 0 or n == 0 or k == 0:
        return torch.full((m, n), float("-inf"), dtype=a.dtype, device=a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _launch(_kernel(a.dtype, single_pair=True), a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, k, n, _TILE_BM)
    maxmin_matmul.launches += 1
    return out


maxmin_matmul.launches = 0
