"""Kernel B5's wrapper: the ELL gather-contract.

    out[j, m, v] = max over (u, e) with idx[j, u, e] == v of
                   min(d[j, m, u], ts[j, u, e])      (zero where none)

The counterpart of ``repro.kernels.ell.ell.ell_gather_contract_fused``,
on float32 timestamps (zero -inf) and on int32 levels (zero 0).
On a CUDA tensor it launches the hand-written Hopper kernel in
``repro_torch/csrc/ell.cu`` (built by nvcc at first use) or raises; it
takes the plain PyTorch version only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import bind, call_on
from .ref import ell_gather_contract_ref

NEG_INF = float("-inf")

_INT_MAX = 2**31 - 1


#: the kernel's entry per element type: float32 timestamps and the
#: bucket backend's int32 levels
_ENTRIES = {torch.float32: "ell_gather_contract_f32",
            torch.int32: "ell_gather_contract_s32"}


def _zero(dtype: torch.dtype):
    """The semiring zero of an element type: -inf on floats, 0 on levels."""
    return NEG_INF if dtype.is_floating_point else 0


def _kernel(dtype: torch.dtype):
    return bind("ell", _ENTRIES[dtype], [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])


def ell_gather_contract(d: torch.Tensor, idx: torch.Tensor,
                        ts: torch.Tensor) -> torch.Tensor:
    """Batched gather-contract d (J, M, U) x ELL rows idx (J, U, E) int32 /
    ts (J, U, E) -> (J, M, U), one launch for all J rows. The element type
    sets the semiring zero the output starts from and free slots carry:
    -inf on float32 timestamps, 0 on the bucket backend's int32 levels.

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
        return ell_gather_contract_ref(d, idx, ts, zero=_zero(d.dtype))
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    if d.dtype not in _ENTRIES or ts.dtype != d.dtype:
        raise TypeError(f"kernel B5 takes float32 or int32 d and ts of one "
                        f"type, got {d.dtype}, {ts.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"kernel B5 takes int32 idx, got {idx.dtype}")
    if not (d.is_contiguous() and idx.is_contiguous() and ts.is_contiguous()):
        raise ValueError("kernel B5 takes contiguous operands")
    e = idx.shape[2]
    if j * m > _INT_MAX or j * u * e > _INT_MAX or u > _INT_MAX:
        raise ValueError(f"J*M={j * m} or J*U*E={j * u * e} exceeds int32")
    out = torch.full((j, m, u), _zero(d.dtype), dtype=d.dtype, device=d.device)
    if j == 0 or m == 0 or u == 0 or e == 0:
        return out
    err = call_on(d, _kernel(d.dtype), d.data_ptr(), idx.data_ptr(), ts.data_ptr(),
                  out.data_ptr(), j, m, u, e)
    if err != 0:
        raise RuntimeError(f"ell gather-contract launch failed: CUDA error {err}")
    ell_gather_contract.launches += 1
    return out


ell_gather_contract.launches = 0
