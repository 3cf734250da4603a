"""Plain PyTorch versions of the level-quantized bottleneck product.

Timestamps quantized to integer levels 0..T (0 = unreachable, the
semiring zero). On levels the (max, min) product decomposes over
thresholds:

    C[i, j] = sum_{theta=1..T} [ exists k: A[i, k] >= theta and B[k, j] >= theta ]

because level-valued bottleneck reachability is monotone in theta. Each
threshold term is a boolean product, (0/1 product > 0). The counterpart
of ``repro.kernels.bucket.ref``, plus the batched form the port's
``BucketBackend.contract_rows`` needs. These are the yardstick the CUDA
kernels are held against, so they may use ``torch.matmul`` on 0/1
operands; they run on any device. The 0/1 sums are exact in float32 for
any k < 2**24, and every chunking below gives the same integers.
"""
from __future__ import annotations

import torch

#: budget for one chunk's float32 0/1 operands and product, in bytes
_CHUNK_BYTES = 1 << 30


def bucket_maxmin_ref(a_lvl: torch.Tensor, b_lvl: torch.Tensor,
                      n_levels: int) -> torch.Tensor:
    """a_lvl (m, k) int32 levels in [0, T], b_lvl (k, n) -> (m, n) int32
    levels = max_k min(a, b) computed exactly on levels (T = n_levels)."""
    return bucket_maxmin_fused_ref(a_lvl[None], b_lvl[None], n_levels)[0]


def bucket_maxmin_fused_ref(a_lvl: torch.Tensor, b_lvl: torch.Tensor,
                            n_levels: int) -> torch.Tensor:
    """Batched threshold decomposition a (J, m, k) x b (J, k, n) ->
    (J, m, n) int32, chunked over J so one chunk's 0/1 operands and
    product stay under about 1 GiB (at J=40, N=2048 one threshold's
    operands are 1.3 GB)."""
    j, m, k = a_lvl.shape
    j2, k2, n = b_lvl.shape
    if (j, k) != (j2, k2):
        raise ValueError(f"shape mismatch: {tuple(a_lvl.shape)} x {tuple(b_lvl.shape)}")
    out = torch.zeros((j, m, n), dtype=torch.int32, device=a_lvl.device)
    if j == 0 or m == 0 or n == 0 or k == 0:
        return out
    per_row = 4 * (m * k + k * n + m * n)
    rows = max(1, _CHUNK_BYTES // per_row)
    for j0 in range(0, j, rows):
        j1 = min(j, j0 + rows)
        a, b, acc = a_lvl[j0:j1], b_lvl[j0:j1], out[j0:j1]
        for theta in range(1, n_levels + 1):
            ab = (a >= theta).to(torch.float32)
            bb = (b >= theta).to(torch.float32)
            acc += (torch.matmul(ab, bb) > 0.5).to(torch.int32)
    return out


def bucket_maxmin_exact(a_lvl: torch.Tensor, b_lvl: torch.Tensor) -> torch.Tensor:
    """Direct max-min on levels over the leading batch dims (an independent
    oracle for the decomposition; test sizes only)."""
    return torch.amax(torch.minimum(a_lvl[..., :, :, None], b_lvl[..., None, :, :]),
                      dim=-2).to(torch.int32)
