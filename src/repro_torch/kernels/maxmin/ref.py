"""Plain PyTorch versions of the (max, min) bottleneck-semiring product.

    C[j, i, n] = max_k min(A[j, i, k], B[j, k, n])

The counterpart of ``repro.kernels.maxmin.ref``: -inf encodes
"unreachable / no edge" and is the semiring zero. These run on any
device; the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against them on the card. Max and
min never reassociate, so every chunking gives bit-identical results.
"""
from __future__ import annotations

import torch

#: budget for the (rows, chunk, n) broadcast intermediate, in bytes
_INTERMEDIATE_BYTES = 1 << 30


def maxmin_matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, *,
                            chunk: int = 128) -> torch.Tensor:
    """Batched (max, min) product a (J, m, k) x b (J, k, n) -> (J, m, n).

    Chunked over k as ``maxmin_matmul_ref`` is (the chunk adapts down to
    the 32-aligned k for small problems), and over J and rows so that the
    (rows, chunk, n) intermediate stays under about 1 GiB: at J=48,
    N=2048 the unchunked intermediate would be 1.6 TB. The last k chunk
    is ragged instead of padded, which is exact."""
    j, m, k = a.shape
    j2, k2, n = b.shape
    if (j, k) != (j2, k2):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    out = torch.full((j, m, n), float("-inf"), dtype=a.dtype, device=a.device)
    if j == 0 or m == 0 or n == 0:
        return out
    chunk = max(1, min(chunk, k + (-k) % 32))
    per_row = chunk * n * a.element_size()
    rows = max(1, _INTERMEDIATE_BYTES // per_row)
    for j0 in range(j):
        for i0 in range(0, m, rows):
            i1 = min(m, i0 + rows)
            acc = out[j0, i0:i1]
            for k0 in range(0, k, chunk):
                k1 = min(k, k0 + chunk)
                asl = a[j0, i0:i1, k0:k1]              # (rows, kc)
                bsl = b[j0, k0:k1]                     # (kc, n)
                c = torch.amax(torch.minimum(asl[:, :, None], bsl[None]), dim=1)
                torch.maximum(acc, c, out=acc)
    return out


def maxmin_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                      chunk: int = 128) -> torch.Tensor:
    """Single-pair (max, min) product a (m, k) x b (k, n) -> (m, n), the
    counterpart of ``repro.kernels.maxmin.ref.maxmin_matmul_ref`` (the
    J = 1 case of :func:`maxmin_matmul_fused_ref`)."""
    return maxmin_matmul_fused_ref(a[None], b[None], chunk=chunk)[0]


def maxmin_matmul_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unchunked one-liner over the leading batch dims (test sizes only)."""
    return torch.amax(torch.minimum(a[..., :, :, None], b[..., None, :, :]),
                      dim=-2)
