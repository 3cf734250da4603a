"""Kernel B1's wrapper: the fused batched (max, min) product.

    out[j] = max_k min(a[j], b[j])    a (J, m, k), b (J, k, n) -> (J, m, n)

The counterpart of ``repro.kernels.maxmin.maxmin.maxmin_matmul_fused``.
On a CUDA tensor it launches the hand-written Hopper kernel in
``repro_torch/csrc/maxmin.cu`` (built by nvcc at first use) or raises; it
takes the plain PyTorch version only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import maxmin_matmul_fused_ref

#: the port's Hopper tile table, one entry so far: BM=128 names, to the CUDA
#: source's ``dispatch``, a 128 x 128 output tile with an 8 x 8 register
#: block per thread, for the dense round's square (N, N) slabs. It is exact
#: for every m, k, n >= 1 (-inf fills the ragged edges); a tile for skinny
#: slabs belongs with the frontier slice (ROADMAP B1).
_TILE_BM = 128

_FUNCS = {torch.float32: "maxmin_fused_f32", torch.float16: "maxmin_fused_f16"}


def _kernel(dtype: torch.dtype):
    lib = load("maxmin")
    fn = getattr(lib, _FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in _FUNCS:
        raise TypeError(f"kernel B1 takes float32 or float16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kernel B1 takes contiguous operands")
    if j > 65535:
        raise ValueError(f"J={j} exceeds the grid's z extent (65535)")
    if j == 0 or m == 0 or n == 0 or k == 0:
        return torch.full((j, m, n), float("-inf"), dtype=a.dtype, device=a.device)
    out = torch.empty((j, m, n), dtype=a.dtype, device=a.device)
    fn = _kernel(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 j, m, k, n, _TILE_BM, stream)
    if err != 0:
        raise RuntimeError(f"maxmin kernel launch failed: CUDA error {err}")
    maxmin_matmul_fused.launches += 1
    return out


maxmin_matmul_fused.launches = 0
