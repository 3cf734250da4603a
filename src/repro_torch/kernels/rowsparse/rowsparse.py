"""Kernel B6's wrapper: the row-sparse dist gather.

    out[m, e] = max over slots c with idx[m, c] == e of ts[m, c]   (-inf where none)

The counterpart of ``repro.kernels.rowsparse.rowsparse.rowsparse_gather_fused``.
On a CUDA tensor it launches the hand-written Hopper kernel in
``repro_torch/csrc/rowsparse.cu`` (built by nvcc at first use) or raises;
it takes the plain PyTorch version only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import bind, call_on
from .ref import rowsparse_gather_ref

_INT_MAX = 2**31 - 1
#: the C entry's argument types: idx, ts, out, M, C, E, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rowsparse_gather(idx: torch.Tensor, ts: torch.Tensor, e: int) -> torch.Tensor:
    """Densify gathered slot rows idx (M, C) int32 / ts (M, C) f32 ->
    (M, E) f32, one launch for all M rows. The semiring zero is -inf (raw
    float32 timestamps, as the reference's ``gather_dist_rows`` hook).

    ``rowsparse_gather.launches`` counts the kernel launches (plain int);
    CPU calls and empty problems launch nothing and count nothing."""
    if idx.dim() != 2 or idx.shape != ts.shape:
        raise ValueError(f"expected idx and ts of one (M, C) shape, got idx "
                         f"{tuple(idx.shape)}, ts {tuple(ts.shape)}")
    if e < 1:
        raise ValueError(f"E must be >= 1, got {e}")
    if idx.device != ts.device:
        raise ValueError(f"operands on different devices: {idx.device}, "
                         f"{ts.device}")
    if idx.device.type == "cpu":
        return rowsparse_gather_ref(idx, ts, e)
    if idx.device.type != "cuda":
        raise ValueError(f"no kernel for device {idx.device}")
    if ts.dtype != torch.float32:
        raise TypeError(f"kernel B6 takes float32 ts, got {ts.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"kernel B6 takes int32 idx, got {idx.dtype}")
    if not (idx.is_contiguous() and ts.is_contiguous()):
        raise ValueError("kernel B6 takes contiguous operands")
    m, c = idx.shape
    if m > _INT_MAX or c > _INT_MAX or e > _INT_MAX:
        raise ValueError(f"M={m}, C={c} or E={e} exceeds int32")
    # the kernel writes every output element: no fill pass
    out = torch.empty((m, e), dtype=ts.dtype, device=ts.device)
    if m == 0:
        return out
    err = call_on(idx, bind("rowsparse", "rowsparse_gather_f32", _ARGTYPES),
                  idx.data_ptr(), ts.data_ptr(), out.data_ptr(), m, c, e)
    if err != 0:
        raise RuntimeError(f"row-sparse gather launch failed: CUDA error {err}")
    rowsparse_gather.launches += 1
    return out


rowsparse_gather.launches = 0
