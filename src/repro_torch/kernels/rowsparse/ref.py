"""Plain PyTorch versions of the row-sparse dist gather.

    out[m, e] = max over slots c with idx[m, c] == e of ts[m, c]   (-inf where none)

The counterpart of ``repro.kernels.rowsparse.ref``: the densify of M
gathered row-sparse dist rows (each a set of ``dist_cap`` flattened
``v * K + k`` keys) into the dense (M, E) slab the frontier rounds relax,
where ``E = N * K``. Free slots carry ``ts == -inf`` and a stale but
in-range ``idx``, which never wins the max. These run on any device; the
CPU tests hold them against the JAX package, and ``chip_smoke.py`` holds
kernel B6 against them on the card. A scatter-max never reassociates, so
they agree bit for bit.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")


def rowsparse_gather_ref(idx: torch.Tensor, ts: torch.Tensor,
                         e: int) -> torch.Tensor:
    """Densify gathered slot rows: idx (M, C) int / ts (M, C) -> (M, E), one
    scatter-max."""
    if ts.shape != idx.shape:
        raise ValueError(f"shape mismatch: idx {tuple(idx.shape)}, ts "
                         f"{tuple(ts.shape)}")
    out = torch.full((idx.shape[0], e), NEG_INF, dtype=ts.dtype,
                     device=ts.device)
    return out.scatter_reduce_(1, idx.long(), ts, "amax", include_self=True)


def rowsparse_gather_naive(idx: torch.Tensor, ts: torch.Tensor,
                           e: int) -> torch.Tensor:
    """One-hot compare-and-fold oracle; O(M * C * E) scratch, tests only."""
    hit = idx.long()[:, :, None] == torch.arange(e, device=idx.device)
    return torch.where(hit, ts[:, :, None], NEG_INF).amax(dim=1)
