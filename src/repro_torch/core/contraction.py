"""Contraction backends: the closure round's contraction as an object.

The counterpart of ``repro.core.backend`` (its ``ContractionBackend``
hooks, lines 76-262), trimmed to what the dense, ELL and row-sparse
rounds need:

  * :meth:`Backend.contract_rows` — batched max-min over gathered
    transition rows, ``d_s (J, M, N)[x, u] x a_l (J, N, N)[u, v]``;
  * :meth:`Backend.contract_batched` — the dense round's gather, contract
    and row masking;
  * :meth:`Backend.contract_rows_ell` / :meth:`Backend.contract_batched_ell`
    — the same against padded-ELL adjacency rows (kernel B5 on the card),
    with the spill ring folded in plain PyTorch (:meth:`Backend._fold_spill`,
    which the reference also keeps outside its kernel);
  * :meth:`Backend.gather_dist_rows` — the row-sparse dist's densify of
    the gathered frontier rows (kernel B6 on the card), on raw float32
    timestamps with a -inf zero;
  * :meth:`Backend.prepare_state` / :meth:`Backend.decode_state` — the
    operand representation at the dispatch boundary (identity here: both
    backends work on float32 timestamps);
  * :attr:`Backend.zero` (-inf) and :attr:`Backend.exact` (True).

Two backends, both bit-identical (max and min never reassociate):

``"plain"`` (:class:`PlainBackend`)
    The chunked plain PyTorch product — the counterpart of ``JnpBackend``.
``"cuda"`` (:class:`KernelBackend`, the default)
    Kernels B1 (dense adjacency), B5 (ELL adjacency) and B6 (row-sparse
    dist gather), written by hand for Hopper — the counterpart of
    ``PallasBackend``. One launch per
    round covers every transition row. On CPU tensors the kernels'
    wrappers take their plain versions.

``"mxu_bucket"`` (the level-quantized tensor-core mode) is not yet ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..kernels.ell.ell import ell_gather_contract
from ..kernels.ell.ref import ell_gather_contract_ref
from ..kernels.maxmin.maxmin import maxmin_matmul_fused
from ..kernels.maxmin.ref import maxmin_matmul_fused_ref
from ..kernels.rowsparse.ref import rowsparse_gather_ref
from ..kernels.rowsparse.rowsparse import rowsparse_gather
from .sparse_adj import EllAdjacency

NEG_INF = float("-inf")

#: backend names resolve_backend accepts; the first is the default
KNOWN_BACKENDS = ("cuda", "plain")
#: backends of the reference package that are not ported yet, with the
#: ROADMAP item that brings each
NOT_PORTED = {"mxu_bucket": "ROADMAP B3"}


class Backend:
    """One relaxation round's contraction substrate (see module docstring).

    Instances compare and hash by name, so a service group accepts two
    instances of one backend as the same backend."""

    name: str = "abstract"
    exact: bool = True
    #: semiring zero in the backend's operand representation
    zero: float = NEG_INF

    def __eq__(self, other) -> bool:
        return isinstance(other, Backend) and self.name == other.name

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.name))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<{type(self).__name__} {self.name!r}>"

    # -- state representation hooks ------------------------------------------

    def prepare_state(self, dist, adj, now=None, w_max=None):
        """(dist, adj) f32 timestamps -> closure operands (identity)."""
        return dist, adj

    def decode_state(self, dist, now=None, w_max=None):
        """Closure-result operand -> f32 timestamps (identity)."""
        return dist

    # -- contraction ---------------------------------------------------------

    def contract_rows(self, d_s: torch.Tensor, a_l: torch.Tensor) -> torch.Tensor:
        """d_s (J, M, N)[x, u] x a_l (J, N, N)[u, v] -> (J, M, N)[x, v]."""
        raise NotImplementedError

    def contract_batched(self, dist: torch.Tensor, adj: torch.Tensor, btt,
                         mask: torch.Tensor) -> torch.Tensor:
        """The dense round's contraction: gather each transition row's
        operands from dist (Q, N, N, K) / adj (L, N, N) per the flattened
        table ``btt``, contract, and zero the rows ``mask`` (J,) leaves
        out. Returns (J, N, N); masked rows carry :attr:`zero`."""
        n = dist.shape[1]
        # advanced indices split by slices go first, as in numpy and JAX
        d_s = dist[btt.qidx, :, :, btt.src]           # (J, N, N) [x, u]
        if d_s.shape != (btt.qidx.shape[0], n, n):
            raise AssertionError(f"gathered operand has shape {tuple(d_s.shape)}")
        a_l = adj[btt.lab]                            # (J, N, N) [u, v]
        contrib = self.contract_rows(d_s, a_l)
        del d_s, a_l
        return contrib.masked_fill_(~mask[:, None, None], self.zero)

    # -- ELL (blocked-sparse adjacency) contraction --------------------------
    #
    # The ``adj_layout="ell"`` axis: the same contractions with an
    # :class:`~repro_torch.core.sparse_adj.EllAdjacency` operand. Max and
    # min never reassociate and free slots fold to -inf, so every variant
    # is bit-identical to the dense hook on ``ell_to_dense(adj)``.

    def _gather_contract(self, d, idx, ts) -> torch.Tensor:
        """d (J, M, U) x ELL rows idx/ts (J, U, E) -> (J, M, U)."""
        raise NotImplementedError

    def _fold_spill(self, contrib, d_s, ell: EllAdjacency, labs):
        """Fold the spill ring into a gather-contract result in place: for
        ring entries on transition j's label, ``contrib[j, :, dst] max=
        min(d_s[j, :, src], spill_ts)``. Free ring entries carry -inf and
        annihilate."""
        j, m, _ = contrib.shape
        eff = torch.where(ell.spill_lab.long()[None, :] == labs[:, None],
                          ell.spill_ts[None, :], self.zero)          # (J, S)
        d_sp = d_s.index_select(2, ell.spill_src.long())             # (J, M, S)
        cand = torch.minimum(d_sp, eff[:, None, :].to(d_s.dtype))
        dst = ell.spill_dst.long()[None, None, :].expand(cand.shape)
        return contrib.scatter_reduce_(2, dst, cand, "amax", include_self=True)

    def contract_rows_ell(self, d_s, ell: EllAdjacency, labs) -> torch.Tensor:
        """Batched max-min over u against ELL rows: d_s (J, M, N)[x, u] x
        the per-label slot rows of ``ell`` -> (J, M, N)[x, v], O(M*N*E)
        work instead of the dense O(M*N*N)."""
        labs = labs.long()
        contrib = self._gather_contract(d_s.contiguous(), ell.idx[labs],
                                        ell.ts[labs])
        return self._fold_spill(contrib, d_s, ell, labs)

    def contract_batched_ell(self, dist, ell: EllAdjacency, btt,
                             mask) -> torch.Tensor:
        """ELL twin of :meth:`contract_batched` (same gather of dist, same
        masking contract)."""
        d_s = dist[btt.qidx, :, :, btt.src]           # (J, N, N) [x, u]
        contrib = self.contract_rows_ell(d_s, ell, btt.lab)
        del d_s
        return contrib.masked_fill_(~mask[:, None, None], self.zero)

    # -- row-sparse dist gather ----------------------------------------------

    def gather_dist_rows(self, idx, ts, e: int) -> torch.Tensor:
        """Densify gathered row-sparse dist slot rows: idx (M, C) int32 /
        ts (M, C) f32 -> the (M, E) f32 slab a frontier round relaxes. Raw
        float32 timestamps with a -inf zero whatever :attr:`zero` is: the
        caller encodes the slab at the backend boundary, as the reference
        does."""
        raise NotImplementedError


class PlainBackend(Backend):
    """Chunked plain PyTorch (max, min) contraction — the oracle."""

    name = "plain"

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused_ref(d_s, a_l)

    def _gather_contract(self, d, idx, ts):
        return ell_gather_contract_ref(d, idx, ts)

    def gather_dist_rows(self, idx, ts, e):
        return rowsparse_gather_ref(idx, ts, e)


class KernelBackend(Backend):
    """Kernels B1 (``repro_torch/csrc/maxmin.cu``) and B5
    (``repro_torch/csrc/ell.cu``): one launch per round for all J
    transition rows; and B6 (``repro_torch/csrc/rowsparse.cu``): one launch
    per row-sparse frontier dispatch for all gathered rows. Bit-identical
    to :class:`PlainBackend`."""

    name = "cuda"

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused(d_s, a_l)

    def _gather_contract(self, d, idx, ts):
        return ell_gather_contract(d, idx, ts)

    def gather_dist_rows(self, idx, ts, e):
        return rowsparse_gather(idx, ts, e)


BackendLike = Union[None, str, Backend]

_SINGLETONS: Dict[str, Backend] = {}
_CLASSES = {"cuda": KernelBackend, "plain": PlainBackend}


def resolve_backend(backend: Optional[BackendLike] = None) -> Backend:
    """Backend instance for a name (validated), an instance (passed
    through) or None (the kernel backend)."""
    if backend is None:
        backend = KNOWN_BACKENDS[0]
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        if backend in NOT_PORTED:
            raise NotImplementedError(
                f"backend {backend!r} is not yet ported ({NOT_PORTED[backend]}); "
                f"known backends: {', '.join(KNOWN_BACKENDS)}")
        if backend not in _CLASSES:
            raise ValueError(
                f"unknown backend {backend!r}; known backends: "
                f"{', '.join(KNOWN_BACKENDS)}")
        if backend not in _SINGLETONS:
            _SINGLETONS[backend] = _CLASSES[backend]()
        return _SINGLETONS[backend]
    raise TypeError(f"backend must be a name or a Backend, got {type(backend)!r}")
