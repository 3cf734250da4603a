"""Plain PyTorch versions of the ELL gather-contract.

    out[j, m, v] = max over (u, e) with idx[j, u, e] == v of
                   min(d[j, m, u], ts[j, u, e])

and of the whole contraction a backend's ``contract_rows_ell`` runs
(:func:`ell_contract_rows_ref`): the same on the ELL rows of each row's
label, with the spill ring folded in.

The counterpart of ``repro.kernels.ell.ref``: the (max, min) contraction
of a row block ``d`` against padded-ELL adjacency rows, without
densifying the (N, N) label slab. Free slots carry ``ts == zero`` (-inf),
so their candidates fold away under the scatter-max. These run on any
device; the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against them on the card. Max and
min never reassociate, so every chunking gives bit-identical results.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")

#: budget for the (rows, u_chunk, E) candidate tensor, in bytes
_CANDIDATE_BYTES = 1 << 29


def ell_gather_contract_ref(d: torch.Tensor, idx: torch.Tensor,
                            ts: torch.Tensor, *, zero: float = NEG_INF,
                            u_chunk: int = 2048) -> torch.Tensor:
    """Batched gather-contract d (J, M, U) x ELL rows idx/ts (J, U, E) ->
    (J, M, U). Per transition row j and u-chunk, the candidate tensor
    ``min(d[:, u], ts[u, e])`` of shape (rows, u_chunk, E) is built and
    scatter-maxed into the output at ``idx[u, e]``; rows are chunked so
    the candidate tensor stays under about 512 MiB."""
    j, m, u = d.shape
    if idx.shape != ts.shape or idx.shape[:2] != (j, u):
        raise ValueError(f"shape mismatch: d {tuple(d.shape)}, idx "
                         f"{tuple(idx.shape)}, ts {tuple(ts.shape)}")
    e = idx.shape[2]
    out = torch.full((j, m, u), zero, dtype=d.dtype, device=d.device)
    if j == 0 or m == 0 or u == 0 or e == 0:
        return out
    chunk = max(1, min(u_chunk, u))
    rows = max(1, _CANDIDATE_BYTES // (chunk * e * d.element_size()))
    for j0 in range(j):
        for u0 in range(0, u, chunk):
            u1 = min(u, u0 + chunk)
            t_c = ts[j0, u0:u1].to(d.dtype)                   # (uc, E)
            i_c = idx[j0, u0:u1].reshape(1, -1).long()        # (1, uc*E)
            for m0 in range(0, m, rows):
                m1 = min(m, m0 + rows)
                cand = torch.minimum(d[j0, m0:m1, u0:u1, None], t_c[None])
                out[j0, m0:m1].scatter_reduce_(
                    1, i_c.expand(m1 - m0, -1), cand.reshape(m1 - m0, -1),
                    "amax", include_self=True)
    return out


def ell_contract_rows_ref(d: torch.Tensor, ell_idx: torch.Tensor,
                          ell_ts: torch.Tensor, labs: torch.Tensor,
                          spill_src: torch.Tensor, spill_dst: torch.Tensor,
                          spill_lab: torch.Tensor, spill_ts: torch.Tensor, *,
                          zero: float = NEG_INF) -> torch.Tensor:
    """d (J, M, U) against the ELL rows of label ``labs[j]`` (leaves
    (L, U, E)) and the spill ring's (S,) leaves -> (J, M, U): the
    gather-contract on ``ell_idx[labs]`` / ``ell_ts[labs]``, then for ring
    entries on row j's label ``out[j, :, dst] max= min(d[j, :, src],
    spill_ts)``. Free ring entries carry ``zero`` and annihilate; an entry
    whose src or dst lies outside [0, U) is dropped, as JAX's scatter
    drops out-of-range updates."""
    labs = labs.long()
    out = ell_gather_contract_ref(d, ell_idx[labs], ell_ts[labs], zero=zero)
    u = d.shape[2]
    src, dst = spill_src.long(), spill_dst.long()
    ok = (src >= 0) & (src < u) & (dst >= 0) & (dst < u)
    hit = (spill_lab.long()[None, :] == labs[:, None]) & ok[None, :]  # (J, S)
    eff = torch.where(hit, spill_ts[None, :].to(d.dtype), zero)
    d_sp = d.index_select(2, torch.where(ok, src, 0))                  # (J, M, S)
    cand = torch.minimum(d_sp, eff[:, None, :])
    dst = torch.where(ok, dst, 0)[None, None, :].expand(cand.shape)
    return out.scatter_reduce_(2, dst, cand, "amax", include_self=True)


def ell_gather_contract_naive(d: torch.Tensor, idx: torch.Tensor,
                              ts: torch.Tensor, *,
                              zero: float = NEG_INF) -> torch.Tensor:
    """Densify-then-contract one-liner over the batch; O(J * M * N * N)
    scratch, tests only."""
    j, u, e = idx.shape
    a = torch.full((j, u, u), zero, dtype=ts.dtype, device=ts.device)
    a.scatter_reduce_(2, idx.long(), ts, "amax", include_self=True)
    return torch.amax(torch.minimum(d[:, :, :, None], a[:, None].to(d.dtype)),
                      dim=2)
