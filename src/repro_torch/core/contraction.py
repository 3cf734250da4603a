"""Contraction backends: the closure round's contraction as an object.

The counterpart of ``repro.core.backend`` (its ``ContractionBackend``
hooks and its three backends):

  * :meth:`Backend.contract` — the single-pair max-min of the legacy
    single-query round, ``d (N, N)[x, u] x a (N, N)[u, v]``;
  * :meth:`Backend.contract_rows` — batched max-min over gathered
    transition rows, ``d_s (J, M, N)[x, u] x a_l (J, N, N)[u, v]``;
  * :meth:`Backend.contract_batched` — the dense round's gather, contract
    and row masking;
  * :meth:`Backend.contract_rows_ell` — the same against the padded-ELL
    adjacency rows of each transition row's label, the spill ring folded
    in (kernel B5 on the card, one launch; the reference gathers the rows
    and folds the ring around its kernel). The dense round gathers its
    operand and masks rows itself, chunked over J
    (``semiring._round_update``);
  * :meth:`Backend.gather_dist_rows` — the row-sparse dist's densify of
    the gathered frontier rows (kernel B6 on the card), on raw float32
    timestamps with a -inf zero;
  * :meth:`Backend.prepare_state` / :meth:`Backend.decode_state` — the
    operand representation at the dispatch boundary (identity for the
    float backends, int32 levels for the bucket backend);
  * :attr:`Backend.zero` (-inf, or level 0) and :attr:`Backend.exact`.

Backends compare and hash by configuration (:meth:`Backend.config_key`),
as the reference's do: a service group takes two equally configured
instances as one backend and refuses two that differ.

Three backends:

``"plain"`` (:class:`PlainBackend`)
    The chunked plain PyTorch product — the counterpart of ``JnpBackend``.
``"cuda"`` (:class:`KernelBackend`, the default)
    Kernels B1 (dense adjacency), B5 (ELL adjacency), B6 (row-sparse
    dist gather) and B2 (the legacy round's single pair), written by hand
    for Hopper — the counterpart of ``PallasBackend``. One launch per
    round covers every transition row. On CPU tensors the kernels'
    wrappers take their plain versions. Bit-identical to ``"plain"``
    (max and min never reassociate).
``"mxu_bucket"`` (:class:`BucketBackend`)
    The level-quantized closure on int8 tensor cores — the counterpart
    of the reference's ``BucketBackend``: inside a dispatch the state
    lives as int32 levels on an absolute time grid, the contractions are
    kernels B3 (dense round), B4 (single pair) and B5 on int32 (ELL), and
    the result decodes to grid timestamps: a coarsened expiry, not an
    exact one.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..kernels.bucket.bucket import bucket_maxmin, bucket_maxmin_fused
from ..kernels.bucket.ref import bucket_maxmin_fused_ref, bucket_maxmin_ref
from ..kernels.ell.ell import ell_contract_rows
from ..kernels.ell.ref import ell_contract_rows_ref
from ..kernels.maxmin.maxmin import maxmin_matmul, maxmin_matmul_fused
from ..kernels.maxmin.ref import maxmin_matmul_fused_ref, maxmin_matmul_ref
from ..kernels.rowsparse.ref import rowsparse_gather_ref
from ..kernels.rowsparse.rowsparse import rowsparse_gather
from .sparse_adj import EllAdjacency

NEG_INF = float("-inf")

#: backend names resolve_backend accepts; the first is the default
KNOWN_BACKENDS = ("cuda", "plain", "mxu_bucket")


def _ring(ell: EllAdjacency):
    """The spill ring's four leaves, in kernel B5's argument order."""
    return ell.spill_src, ell.spill_dst, ell.spill_lab, ell.spill_ts


class Backend:
    """One relaxation round's contraction substrate (see module docstring).

    Instances compare and hash by configuration (:meth:`config_key`), so
    a service group accepts two equally configured instances as the same
    backend and refuses two that differ. Subclasses that add
    configuration attributes fold them into :meth:`config_key`."""

    name: str = "abstract"
    exact: bool = True
    #: semiring zero in the backend's operand representation
    zero: float = NEG_INF

    def config_key(self) -> tuple:
        """Hashable full-configuration identity (type and every attribute
        that changes what the backend computes)."""
        return (type(self).__name__, self.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, Backend) and self.config_key() == other.config_key()

    def __hash__(self) -> int:
        return hash(self.config_key())

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

    def contract(self, d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Single-pair max-min over u: d (N, N)[x, u] x a (N, N)[u, v] ->
        (N, N)[x, v] (the legacy single-query round)."""
        raise NotImplementedError

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
    # min never reassociate and free slots fold to the zero, so every
    # variant is bit-identical to the dense hook on ``ell_to_dense(adj)``.

    def _contract_ell(self, d, ell: EllAdjacency, labs) -> torch.Tensor:
        """d (J, M, U) contiguous against the ELL rows and the ring of
        each row's label -> (J, M, U), starting from :attr:`zero`."""
        raise NotImplementedError

    def contract_rows_ell(self, d_s, ell: EllAdjacency, labs) -> torch.Tensor:
        """Batched max-min over u against ELL rows: d_s (J, M, N)[x, u] x
        the per-label slot rows of ``ell`` and its spill ring -> (J, M,
        N)[x, v], O(M*N*E) work instead of the dense O(M*N*N)."""
        return self._contract_ell(d_s.contiguous(), ell, labs)

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

    def contract(self, d, a):
        return maxmin_matmul_ref(d, a)

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused_ref(d_s, a_l)

    def _contract_ell(self, d, ell, labs):
        return ell_contract_rows_ref(d, ell.idx, ell.ts, labs, *_ring(ell))

    def gather_dist_rows(self, idx, ts, e):
        return rowsparse_gather_ref(idx, ts, e)


class KernelBackend(Backend):
    """Kernels B1 (``repro_torch/csrc/maxmin.cu``) and B5
    (``repro_torch/csrc/ell.cu``, the label gather and the spill ring
    folded in): one launch per round for all J transition rows (per J
    chunk of a dense ELL round); B6 (``repro_torch/csrc/rowsparse.cu``):
    one launch per row-sparse frontier dispatch for all gathered rows; and B2
    (``maxmin.cu`` with J = 1): one launch per transition of the legacy
    round. Bit-identical to :class:`PlainBackend`."""

    name = "cuda"

    def contract(self, d, a):
        return maxmin_matmul(d, a)

    def contract_rows(self, d_s, a_l):
        return maxmin_matmul_fused(d_s, a_l)

    def _contract_ell(self, d, ell, labs):
        return ell_contract_rows(d, ell.idx, ell.ts, labs, *_ring(ell))

    def gather_dist_rows(self, idx, ts, e):
        return rowsparse_gather(idx, ts, e)


class BucketBackend(Backend):
    """Level-quantized boolean closure on int8 tensor cores — the
    counterpart of the reference's ``BucketBackend`` (core/backend.py:
    275-416), operation for operation in float32 where it quantizes.

    Representation: timestamps quantize onto an ABSOLUTE grid of step
    ``w_max / n_levels``; level l decodes to ``origin + l * step`` with
    ``origin = floor((now - w_max) / step) * step``, the window's lower
    edge snapped down to the grid, so re-encoding an on-grid value is the
    identity and the one-time coarsening error never accumulates. Level 0
    is the semiring zero: -inf, and anything at or below ``origin``.
    ``n_levels + 1`` levels are allocated so the sub-step slack between
    ``origin`` and ``now - w_max`` never clips a live value. The grid map
    is monotone, so it commutes with max and min: the level closure is the
    float closure mapped through the grid, elementwise, and results are a
    superset of the float engine's whose extras lie within one level step
    of their query's window boundary (a coarsened expiry).

    State: :meth:`prepare_state` and :meth:`decode_state` make new tensors
    (an int32 copy of dist beside the stored float32 one, as the reference
    does), so callers use the dist a closure returns, never the one they
    passed in. The stored dist stays canonical float32 between dispatches.

    Contraction: kernels B3 (``contract_rows``, the dense and frontier
    rounds), B4 (``contract``, the legacy single-pair round) and B5 on
    int32 (the ELL layout), in ``repro_torch/csrc/bucket.cu`` and
    ``ell.cu``; the row-sparse dist's gather is B6 on raw float32, encoded
    afterwards. ``use_kernels=False`` runs the plain versions everywhere
    (the reference's ``use_pallas=False``); on CPU tensors the kernels'
    wrappers take their plain versions anyway.
    """

    name = "mxu_bucket"
    exact = False
    zero = 0

    #: floor of the snap tolerance (in level-step units) for the grid ceil
    #: (see the reference's ``BucketBackend.GRID_EPS``): a decoded on-grid
    #: value re-encodes through rounded float32 operations, so its ratio can
    #: land slightly above the integer; the applied tolerance is
    #: ``clip(8 * ulp(now) / step, GRID_EPS, 0.45)``
    GRID_EPS: float = 1e-4

    def __init__(self, n_levels: int = 8, use_kernels: bool = True):
        if n_levels < 1:
            raise ValueError(f"n_levels must be >= 1, got {n_levels}")
        self.n_levels = int(n_levels)
        self.use_kernels = bool(use_kernels)

    def config_key(self) -> tuple:
        return (type(self).__name__, self.n_levels, self.use_kernels)

    # -- the absolute level grid ---------------------------------------------

    def _grid(self, now, w_max):
        """(origin, step) as float32 tensors on now's device."""
        now_f = torch.as_tensor(now, dtype=torch.float32)
        w = torch.clamp(torch.as_tensor(w_max, dtype=torch.float32,
                                        device=now_f.device), min=1e-30)
        step = w / self.n_levels
        now_safe = torch.where(torch.isfinite(now_f), now_f, 0.0)
        origin = torch.floor((now_safe - w) / step) * step
        return origin, step

    def encode(self, x: torch.Tensor, now=None, w_max=None) -> torch.Tensor:
        """float32 timestamps -> int32 levels on the grid of (now, w_max)."""
        if now is None or w_max is None:
            raise ValueError(
                "mxu_bucket needs the stream clock: pass now/w_max through "
                "the closure (the executor dispatches do)")
        origin, step = self._grid(now, w_max)
        now_f = torch.as_tensor(now, dtype=torch.float32)
        now_mag = torch.where(torch.isfinite(now_f), torch.abs(now_f), 0.0)
        ulp_now = now_mag * (2.0 ** -23)
        tol = torch.clamp(8.0 * ulp_now / step, self.GRID_EPS, 0.45)
        # the reference's operation order, each step rounded to float32
        lvl = x.sub(origin).div_(step).sub_(tol).ceil_()
        lvl.clamp_(0.0, float(self.n_levels + 1))
        lvl.masked_fill_(~(torch.isfinite(x) & (x > origin)), 0.0)
        return lvl.to(torch.int32)

    def prepare_state(self, dist, adj, now=None, w_max=None):
        """Encode dist and the adjacency (either may be None: the
        row-sparse path encodes each at its own boundary). An ELL
        adjacency encodes its timestamp leaves; free slots (-inf) land on
        level 0, the zero, so they still annihilate."""
        if dist is not None:
            dist = self.encode(dist, now, w_max)
        if isinstance(adj, EllAdjacency):
            adj = adj._replace(ts=self.encode(adj.ts, now, w_max),
                               spill_ts=self.encode(adj.spill_ts, now, w_max))
        elif adj is not None:
            adj = self.encode(adj, now, w_max)
        return dist, adj

    def decode_state(self, dist, now=None, w_max=None):
        """int32 levels -> float32 grid timestamps (level 0 -> -inf)."""
        origin, step = self._grid(now, w_max)
        return torch.where(dist > 0, origin + dist.to(torch.float32) * step,
                           NEG_INF)

    # -- contraction on levels -----------------------------------------------

    @property
    def t_alloc(self) -> int:
        """Thresholds the contraction sums over: ``n_levels + 1``."""
        return self.n_levels + 1

    def contract(self, d, a):
        if self.use_kernels:
            return bucket_maxmin(d, a, n_levels=self.t_alloc)
        return bucket_maxmin_ref(d, a, self.t_alloc)

    def contract_rows(self, d_s, a_l):
        if self.use_kernels:
            return bucket_maxmin_fused(d_s, a_l, n_levels=self.t_alloc)
        return bucket_maxmin_fused_ref(d_s, a_l, self.t_alloc)

    def _contract_ell(self, d, ell, labs):
        if self.use_kernels:
            return ell_contract_rows(d, ell.idx, ell.ts, labs, *_ring(ell))
        return ell_contract_rows_ref(d, ell.idx, ell.ts, labs, *_ring(ell),
                                     zero=self.zero)

    def gather_dist_rows(self, idx, ts, e):
        if self.use_kernels:
            return rowsparse_gather(idx, ts, e)
        return rowsparse_gather_ref(idx, ts, e)


BackendLike = Union[None, str, Backend]

_SINGLETONS: Dict[str, Backend] = {}
_CLASSES = {"cuda": KernelBackend, "plain": PlainBackend,
            "mxu_bucket": BucketBackend}


def resolve_backend(backend: Optional[BackendLike] = None) -> Backend:
    """Backend instance for a name (validated), an instance (passed
    through) or None (the kernel backend)."""
    if backend is None:
        backend = KNOWN_BACKENDS[0]
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        if backend not in _CLASSES:
            raise ValueError(
                f"unknown backend {backend!r}; known backends: "
                f"{', '.join(KNOWN_BACKENDS)}")
        if backend not in _SINGLETONS:
            _SINGLETONS[backend] = _CLASSES[backend]()
        return _SINGLETONS[backend]
    raise TypeError(f"backend must be a name or a Backend, got {type(backend)!r}")
