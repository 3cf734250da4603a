"""Kernels B3 and B4's wrappers: the level-quantized (max, min) product.

    out[j] = max_k min(a[j], b[j])    on int32 levels in [0, T]

``bucket_maxmin_fused`` (B3) takes (J, m, k) x (J, k, n) in one launch,
the counterpart of ``repro.kernels.bucket.bucket.bucket_maxmin_fused``;
``bucket_maxmin`` (B4) takes the single pair (m, k) x (k, n), the
counterpart of ``bucket_maxmin``. On a CUDA tensor each launches the
hand-written Hopper kernels in ``repro_torch/csrc/bucket.cu`` (built by
nvcc at first use: a level pre-pass, then the int8 tensor-core product
over the k tiles and thresholds that can raise an output) or raises; each
takes the plain PyTorch version only for tensors that lie on the CPU.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import bind, call_on
from .ref import bucket_maxmin_fused_ref, bucket_maxmin_ref

#: levels are staged as int8 in the kernel
MAX_LEVELS = 127

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entries: a, b, out, scratch, scratch bytes, (J,) m, k, n, T, stream
_ARGTYPES = {
    "bucket_maxmin_fused_s32": [_P] * 4 + [_LL] + [_I] * 5 + [_P],
    "bucket_maxmin_s32": [_P] * 4 + [_LL] + [_I] * 4 + [_P],
}


def _kernel(name: str):
    return bind("bucket", name, _ARGTYPES[name])


def scratch_bytes(j: int, m: int, k: int, n: int) -> int:
    """Bytes of the scratch one launch needs: the pre-pass's tile flags
    and the operands narrowed to int8 (it writes every byte, so the
    scratch needs no fill)."""
    nbytes = bind("bucket", "bucket_scratch_bytes", [_I] * 4, _LL)(j, m, k, n)
    if nbytes < 0:
        raise ValueError(f"bucket.cu refuses the shape {(j, m, k, n)}")
    return nbytes


def _check_card(a: torch.Tensor, b: torch.Tensor, n_levels: int, what: str) -> None:
    """Raise on what the kernel does not take (device, type, layout, T)."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"kernel {what} takes int32 levels, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"kernel {what} takes contiguous operands")
    if not 0 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"kernel {what} takes 0 <= n_levels <= {MAX_LEVELS}, "
                         f"got {n_levels}")


def _launch(a, b, out, j: int, m: int, k: int, n: int, n_levels: int,
            single_pair: bool) -> None:
    """The pre-pass and the product on a's device and current stream, with
    the scratch in memory from PyTorch's allocator."""
    nbytes = scratch_bytes(j, m, k, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    name, dims = (("bucket_maxmin_s32", (m, k, n)) if single_pair
                  else ("bucket_maxmin_fused_s32", (j, m, k, n)))
    err = call_on(a, _kernel(name), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), nbytes, *dims, n_levels)
    if err != 0:
        raise RuntimeError(f"bucket kernel launch failed: CUDA error {err}")


def bucket_maxmin_fused(a_lvl: torch.Tensor, b_lvl: torch.Tensor, *,
                        n_levels: int) -> torch.Tensor:
    """Kernel B3: batched level product (J, m, k) x (J, k, n) -> (J, m, n)
    int32, T = ``n_levels`` thresholds, one launch for all J rows.

    ``bucket_maxmin_fused.launches`` counts the kernel launches (plain
    int); CPU calls and empty problems launch nothing and count nothing."""
    if a_lvl.dim() != 3 or b_lvl.dim() != 3:
        raise ValueError(f"expected 3-D operands, got {tuple(a_lvl.shape)} x "
                         f"{tuple(b_lvl.shape)}")
    j, m, k = a_lvl.shape
    j2, k2, n = b_lvl.shape
    if (j, k) != (j2, k2):
        raise ValueError(f"shape mismatch: {tuple(a_lvl.shape)} x {tuple(b_lvl.shape)}")
    if a_lvl.device != b_lvl.device:
        raise ValueError(f"operands on different devices: {a_lvl.device}, {b_lvl.device}")
    if a_lvl.device.type == "cpu":
        return bucket_maxmin_fused_ref(a_lvl, b_lvl, n_levels)
    _check_card(a_lvl, b_lvl, n_levels, "B3")
    if j > 65535:
        raise ValueError(f"J={j} exceeds the grid's z extent (65535)")
    if j == 0 or m == 0 or n == 0 or k == 0:
        return torch.zeros((j, m, n), dtype=torch.int32, device=a_lvl.device)
    out = torch.empty((j, m, n), dtype=torch.int32, device=a_lvl.device)
    _launch(a_lvl, b_lvl, out, j, m, k, n, n_levels, single_pair=False)
    bucket_maxmin_fused.launches += 1
    return out


bucket_maxmin_fused.launches = 0


def bucket_maxmin(a_lvl: torch.Tensor, b_lvl: torch.Tensor, *,
                  n_levels: int) -> torch.Tensor:
    """Kernel B4: single-pair level product (m, k) x (k, n) -> (m, n)
    int32 (B3's kernel with J = 1, through its own entry).

    ``bucket_maxmin.launches`` counts the kernel launches (plain int);
    CPU calls and empty problems launch nothing and count nothing."""
    if a_lvl.dim() != 2 or b_lvl.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(a_lvl.shape)} x "
                         f"{tuple(b_lvl.shape)}")
    m, k = a_lvl.shape
    k2, n = b_lvl.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a_lvl.shape)} x {tuple(b_lvl.shape)}")
    if a_lvl.device != b_lvl.device:
        raise ValueError(f"operands on different devices: {a_lvl.device}, {b_lvl.device}")
    if a_lvl.device.type == "cpu":
        return bucket_maxmin_ref(a_lvl, b_lvl, n_levels)
    _check_card(a_lvl, b_lvl, n_levels, "B4")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a_lvl.device)
    out = torch.empty((m, n), dtype=torch.int32, device=a_lvl.device)
    _launch(a_lvl, b_lvl, out, 1, m, k, n, n_levels, single_pair=True)
    bucket_maxmin.launches += 1
    return out


bucket_maxmin.launches = 0
