"""Contraction backends: the closure round's contraction as an object.

The counterpart of ``repro.core.backend`` (its ``ContractionBackend``
hooks, lines 76-262), trimmed to what the dense round needs:

  * :meth:`Backend.contract_rows` — batched max-min over gathered
    transition rows, ``d_s (J, N, N)[x, u] x a_l (J, N, N)[u, v]``;
  * :meth:`Backend.contract_batched` — the dense round's gather, contract
    and row masking;
  * :meth:`Backend.prepare_state` / :meth:`Backend.decode_state` — the
    operand representation at the dispatch boundary (identity here: both
    backends work on float32 timestamps);
  * :attr:`Backend.zero` (-inf) and :attr:`Backend.exact` (True).

Two backends, both bit-identical (max and min never reassociate):

``"plain"`` (:class:`PlainBackend`)
    The chunked plain PyTorch product — the counterpart of ``JnpBackend``.
``"cuda"`` (:class:`KernelBackend`, the default)
    Kernel B1, the hand-written Hopper max-min kernel — the counterpart of
    ``PallasBackend``. One launch per round covers every transition row.
    On CPU tensors the kernel's wrapper takes its plain version.

``"mxu_bucket"`` (the level-quantized tensor-core mode) is not yet ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..kernels.maxmin.maxmin import maxmin_matmul_fused
from ..kernels.maxmin.ref import maxmin_matmul_fused_ref

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


class PlainBackend(Backend):
    """Chunked plain PyTorch (max, min) contraction — the oracle."""

    name = "plain"

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused_ref(d_s, a_l)


class KernelBackend(Backend):
    """Kernel B1 (``repro_torch/csrc/maxmin.cu``): one launch per round
    for all J transition rows; bit-identical to :class:`PlainBackend`."""

    name = "cuda"

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused(d_s, a_l)


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
