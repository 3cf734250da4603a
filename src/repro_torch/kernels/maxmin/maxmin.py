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

from ..build import bind, call_on
from .ref import maxmin_matmul_fused_ref, maxmin_matmul_ref

#: the port's Hopper tile table, one entry so far: BM=128 names, to the CUDA
#: source's ``dispatch``, a 128 x 128 output tile with an 8 x 8 register
#: block per thread and 16-deep k tiles in a 3-stage cp.async ring, after an
#: occupancy pre-pass that lets the product skip k tiles where an operand
#: tile is all -inf. It is exact for every m, k, n >= 1 (-inf fills the
#: ragged edges); skinny (F, N) slabs run it too, their warps past m idle.
_TILE_BM = 128

_FUNCS = {torch.float32: "maxmin_fused_f32", torch.float16: "maxmin_fused_f16"}
_PAIR_FUNCS = {torch.float32: "maxmin_f32", torch.float16: "maxmin_f16"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel(dtype: torch.dtype, single_pair: bool = False):
    """The C entry: a, b, out, flags, flag bytes, (J,) m, k, n, bm, stream."""
    ints = [_I] * (4 if single_pair else 5)
    return bind("maxmin", (_PAIR_FUNCS if single_pair else _FUNCS)[dtype],
                [_P] * 4 + [_LL] + ints + [_P])


def _flag_bytes(j: int, m: int, k: int, n: int) -> int:
    """Bytes of the occupancy flags one launch needs (the pre-pass writes
    every one of them, so they need no fill)."""
    nbytes = bind("maxmin", "maxmin_flag_bytes", [_I] * 5, ctypes.c_longlong)(
        j, m, k, n, _TILE_BM)
    if nbytes < 0:
        raise ValueError(f"no tile entry {_TILE_BM} in maxmin.cu")
    return nbytes


def _check_card(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """Raise on what the kernel does not take (device, type, layout)."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in _FUNCS:
        raise TypeError(f"kernel {what} takes float32 or float16, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"kernel {what} takes contiguous operands")


def _launch(a, b, out, j: int, m: int, k: int, n: int, single_pair: bool) -> None:
    """The pre-pass and the product on a's device and current stream, with
    the flags in memory from PyTorch's allocator."""
    nbytes = _flag_bytes(j, m, k, n)
    flags = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    dims = (m, k, n) if single_pair else (j, m, k, n)
    err = call_on(a, _kernel(a.dtype, single_pair), a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), flags.data_ptr(), nbytes, *dims, _TILE_BM)
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
    _launch(a, b, out, j, m, k, n, single_pair=False)
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
    _launch(a, b, out, 1, m, k, n, single_pair=True)
    maxmin_matmul.launches += 1
    return out


maxmin_matmul.launches = 0
