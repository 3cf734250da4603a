"""Kernel B5's wrapper: the ELL gather-contract.

    out[j, m, v] = max over (u, e) with idx[j, u, e] == v of
                   min(d[j, m, u], ts[j, u, e])      (-inf where none)

The counterpart of ``repro.kernels.ell.ell.ell_gather_contract_fused``.
On a CUDA tensor it launches the hand-written Hopper kernel in
``repro_torch/csrc/ell.cu`` (built by nvcc at first use) or raises; it
takes the plain PyTorch version only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load
from .ref import ell_gather_contract_ref

NEG_INF = float("-inf")

_INT_MAX = 2**31 - 1


def _kernel():
    fn = load("ell").ell_gather_contract_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ell_gather_contract(d: torch.Tensor, idx: torch.Tensor,
                        ts: torch.Tensor) -> torch.Tensor:
    """Batched gather-contract d (J, M, U) f32 x ELL rows idx (J, U, E)
    int32 / ts (J, U, E) f32 -> (J, M, U) f32, one launch for all J rows.
    The semiring zero is -inf (the float lattice); the level lattice of
    the bucket backend is not ported.

    ``ell_gather_contract.launches`` counts the kernel launches (plain
    int); CPU calls and empty problems launch nothing and count nothing."""
    if d.dim() != 3 or idx.dim() != 3 or ts.dim() != 3:
        raise ValueError(f"expected 3-D operands, got d {tuple(d.shape)}, "
                         f"idx {tuple(idx.shape)}, ts {tuple(ts.shape)}")
    j, m, u = d.shape
    if idx.shape != ts.shape or idx.shape[:2] != (j, u):
        raise ValueError(f"shape mismatch: d {tuple(d.shape)}, idx "
                         f"{tuple(idx.shape)}, ts {tuple(ts.shape)}")
    if not (d.device == idx.device == ts.device):
        raise ValueError(f"operands on different devices: {d.device}, "
                         f"{idx.device}, {ts.device}")
    if d.device.type == "cpu":
        return ell_gather_contract_ref(d, idx, ts)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    if d.dtype != torch.float32 or ts.dtype != torch.float32:
        raise TypeError(f"kernel B5 takes float32 d and ts, got {d.dtype}, "
                        f"{ts.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"kernel B5 takes int32 idx, got {idx.dtype}")
    if not (d.is_contiguous() and idx.is_contiguous() and ts.is_contiguous()):
        raise ValueError("kernel B5 takes contiguous operands")
    e = idx.shape[2]
    if j * m > _INT_MAX or j * u * e > _INT_MAX or u > _INT_MAX:
        raise ValueError(f"J*M={j * m} or J*U*E={j * u * e} exceeds int32")
    out = torch.full((j, m, u), NEG_INF, dtype=d.dtype, device=d.device)
    if j == 0 or m == 0 or u == 0 or e == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(d.data_ptr(), idx.data_ptr(), ts.data_ptr(), out.data_ptr(),
                 j, m, u, e, stream)
    if err != 0:
        raise RuntimeError(f"ell gather-contract launch failed: CUDA error {err}")
    ell_gather_contract.launches += 1
    return out


ell_gather_contract.launches = 0
