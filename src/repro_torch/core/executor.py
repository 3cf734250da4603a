"""Executor layer: everything device-facing of the batched dense engine —
the counterpart of ``repro.core.executor``'s local executor: the dense or
the padded-ELL adjacency, the dense or the row-sparse dist, and
``frontier`` off, on or auto.

The engine (:mod:`repro_torch.core.engine`) is pure orchestration. The
device state (:class:`BatchedEngineArrays`, torch tensors on one device)
and every dispatch over it live behind :class:`Executor`:

    ingest_batch / delete_batch   one dispatch per micro-batch (dense or
                                  frontier-restricted; cone-seeded deletes)
    relax                         closure to fixpoint in place
    emit                          per-query window-valid pairs (device)
    arrays / place / grow         state access, (re)placement, growth
    expire / clear_slots / ...    maintenance

The step functions (:func:`apply_batch`, :func:`emit_new`, :func:`_ingest`,
:func:`_ingest_frontier`, :func:`_delete`, :func:`_delete_frontier`,
:func:`_expire`, :func:`_clear_slots`) keep the JAX package's names. They
update the dense state tensors in place where the JAX versions donate their
input (``donate_argnums``): at N=2048 every copy of dist is 0.8 GB. The
ELL adjacency (:mod:`repro_torch.core.sparse_adj`) is small and its
mutations return a new state; the row-sparse dist
(:mod:`repro_torch.core.sparse_dist`) is updated in place by the
frontier dispatch's scatter and by the clears, and re-packed into new
tensors by the dense round trip and by drains.

Round accounting lives here too: ``rounds_total``, ``query_rounds_total``
and ``unmasked_query_rounds_total`` as in the JAX executor, and the
frontier telemetry (``frontier_stats``) whose ``"auto"`` capacity growth
reads it. Counts queue per dispatch and are folded in at the JAX
executor's cadence — every 64 pending dispatches under ``"auto"``, every
256 otherwise, and whenever a counter is read — so capacity growth lands
on the same dispatch as in the reference. ``host_syncs`` counts the
blocking reads the JAX version does not need because its loops and its
fallback choice run on the device: one per closure round, one per
frontier dispatch for the fallback decision, and the reads of the
row-sparse re-pack after a dense round trip. Drains, re-packs and growth
read the device as the JAX executor's do and are not counted.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, device_get, device_put, resolve_device
from .contraction import Backend, BackendLike, resolve_backend
from .semiring import (
    NEG_INF,
    BatchedTransitionTable,
    _closure,
    _frontier,
    batched_valid_pairs,
    ell_round_launches,
)
from .sparse_dist import (
    RowSparseDist,
    from_numpy as rsd_from_numpy,
    rsd_clear_lane,
    rsd_clear_slots,
    rsd_empty_like,
    rsd_empty_np,
    rsd_from_dense,
    rsd_grow_repack,
    rsd_live_entries,
    rsd_row_counts,
    rsd_to_dense,
)
from .sparse_adj import (
    EllAdjacency,
    ell_clear_slots,
    ell_delete,
    ell_entries_degree,
    ell_expire,
    ell_incident,
    ell_insert,
    ell_live_entries,
    ell_max_degree,
    ell_to_dense,
    from_numpy,
    pack_ell,
    pack_ell_dense,
    pack_ell_entries,
)

FRONTIER_MODES = ("off", "on", "auto")
ADJ_LAYOUTS = ("dense", "ell")
DIST_LAYOUTS = ("dense", "row_sparse")


def check_options(**options) -> None:
    """Raise ``ValueError`` for an executor option value the JAX package
    does not know."""
    known = {"frontier": FRONTIER_MODES, "adj_layout": ADJ_LAYOUTS,
             "dist_layout": DIST_LAYOUTS}
    for key, value in options.items():
        if value not in known[key]:
            raise ValueError(f"unknown {key} {value!r}; known: "
                             f"{', '.join(known[key])}")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


class BatchedEngineArrays(NamedTuple):
    adj: object            # (L, N, N) f32 shared, or an EllAdjacency
    dist: object           # (Q, N, N, K) f32, or a RowSparseDist
    emitted: torch.Tensor  # (Q, N, N) bool
    now: torch.Tensor      # () f32


def init_batched_arrays(n_slots: int, n_labels: int, n_queries: int, k: int,
                        device: DeviceLike = None,
                        dist=None) -> BatchedEngineArrays:
    """Empty dense state; ``dist`` replaces the empty dense dist (the
    row-sparse layout passes its own, so no dense slab is made)."""
    dev = resolve_device(device)
    if dist is None:
        dist = torch.full((n_queries, n_slots, n_slots, k), NEG_INF,
                          dtype=torch.float32, device=dev)
    return BatchedEngineArrays(
        adj=torch.full((n_labels, n_slots, n_slots), NEG_INF,
                       dtype=torch.float32, device=dev),
        dist=dist,
        emitted=torch.zeros((n_queries, n_slots, n_slots), dtype=torch.bool,
                            device=dev),
        now=torch.tensor(NEG_INF, dtype=torch.float32, device=dev),
    )


class QueryTables(NamedTuple):
    """Per-lane metadata the engine rebuilds at lifecycle events and the
    executor consumes at every dispatch (tensors on the engine's device;
    ``n_live``, ``max_window`` and ``live_host``, the host mirror of
    ``live_mask`` the mesh executor's shard skip reads, are host values)."""

    btt: BatchedTransitionTable
    finals_mask: torch.Tensor  # (Q, K) bool
    windows: torch.Tensor      # (Q,) f32
    live_mask: torch.Tensor    # (Q,) bool
    n_live: int
    max_window: float = 0.0
    live_host: Optional[np.ndarray] = None  # (Q,) bool


class HostBatch(NamedTuple):
    """A micro-batch's slot, label and mask columns on the host: the ELL
    mutations place events by them without reading the device."""

    src: np.ndarray
    dst: np.ndarray
    lab: np.ndarray
    mask: np.ndarray


def _f32(x, device: torch.device) -> torch.Tensor:
    """A host scalar as a float32 device scalar. The clock arithmetic
    (``now``, ``ts_floor``, ``now - windows``, the expiry threshold) stays
    in float32 tensors, as in the JAX version, so validity at the window
    boundary rounds exactly as the reference does. A fill, not a copy from
    the host: a blocking copy would wait for the stream to drain."""
    return torch.full((), x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# step functions (see the module docstring)
# ---------------------------------------------------------------------------


def apply_batch(arrays: BatchedEngineArrays, src, dst, lab, ts, mask,
                ts_floor, host: Optional[HostBatch] = None):
    """The ingest dispatch prologue: fold the masked batch into the
    adjacency (newest-timestamp max) and advance the stream clock.
    Returns ``(adj, now)``. A dense ``adj`` is updated in place; an ELL
    one scatters into row slots, spilling to the ring on row overflow,
    placed by the host columns ``host`` (the device ones when None).

    A batch may hold one (label, src, dst) twice, and masked rows carry
    -inf: a scatter with ``amax`` keeps the newest timestamp, where an
    accumulating ``index_put_`` would add them."""
    t0 = obs.on and obs.now()
    eff_ts = torch.where(mask, ts, torch.full_like(ts, NEG_INF))
    adj = arrays.adj
    if isinstance(adj, EllAdjacency):
        h = host or HostBatch(src, dst, lab, mask)
        adj = ell_insert(adj, h.src, h.dst, h.lab, eff_ts, h.mask)
    else:
        _, n, _ = adj.shape
        flat = (lab * n + src) * n + dst
        adj.view(-1).scatter_reduce_(0, flat, eff_ts, "amax", include_self=True)
    now = torch.maximum(arrays.now, torch.maximum(eff_ts.max(), ts_floor))
    if t0:
        obs.add("executor.fold", t0)
    return adj, now


def drop_batch(arrays: BatchedEngineArrays, src, dst, lab, mask,
               host: Optional[HostBatch] = None):
    """The delete dispatch prologue: clear the masked batch's adjacency
    entries (in place for a dense ``adj``; every stored copy, row slots
    and ring, for an ELL one). Returns the retained adjacency."""
    t0 = obs.on and obs.now()
    adj = arrays.adj
    if isinstance(adj, EllAdjacency):
        h = host or HostBatch(src, dst, lab, mask)
        adj = ell_delete(adj, h.src, h.dst, h.lab, h.mask)
    else:
        _, n, _ = adj.shape
        flat = (lab * n + src) * n + dst
        # masked rows fold +inf, which min leaves as it was: no boolean
        # index, whose nonzero would read the row count on the host
        clear = torch.where(mask, NEG_INF, float("inf"))
        adj.view(-1).scatter_reduce_(0, flat, clear, "amin", include_self=True)
    if t0:
        obs.add("executor.fold", t0)
    return adj


def emit_new(arrays: BatchedEngineArrays, dist, adj, now, finals_mask,
             windows) -> Tuple[BatchedEngineArrays, torch.Tensor]:
    """The ingest dispatch epilogue: per-query window validity at the new
    clock, diffed against the emitted pairs (``emitted`` is updated in
    place). Returns ``(new_arrays, new)``."""
    t0 = obs.on and obs.now()
    low = now - windows
    valid = batched_valid_pairs(dist, finals_mask, low)
    new = valid & ~arrays.emitted
    emitted = arrays.emitted.logical_or_(valid)
    if t0:
        obs.add("executor.emit", t0)
    return BatchedEngineArrays(adj, dist, emitted, now), new


def _ingest(arrays: BatchedEngineArrays, src, dst, lab, ts, mask, ts_floor,
            btt: BatchedTransitionTable, finals_mask, windows, live_mask,
            w_max, backend: BackendLike = None,
            host: Optional[HostBatch] = None):
    """One ingest dispatch: fold the batch, close every live lane, emit.
    Returns ``(arrays, new, rounds, query_rounds, host_syncs)``."""
    adj, now = apply_batch(arrays, src, dst, lab, ts, mask, ts_floor, host)
    dist, rounds, qrounds, syncs = _closure(
        arrays.dist, adj, btt, backend, 0, live_mask, now, w_max)
    out, new = emit_new(arrays, dist, adj, now, finals_mask, windows)
    return out, new, rounds, qrounds, syncs


def _ingest_frontier(arrays: BatchedEngineArrays, src, dst, lab, ts, mask,
                     ts_floor, btt: BatchedTransitionTable, finals_mask,
                     windows, live_mask, w_max, backend: BackendLike = None,
                     f_cap: int = 32, host: Optional[HostBatch] = None):
    """Frontier-restricted ingest: :func:`_ingest` with the closure
    relaxing only the rows the batch dirtied (dense fallback on overflow).
    Returns ``(arrays, new, rounds, query_rounds, frontier_stats,
    host_syncs)``."""
    adj, now = apply_batch(arrays, src, dst, lab, ts, mask, ts_floor, host)
    dist, rounds, qrounds, fstats, syncs = _frontier(
        arrays.dist, adj, btt, backend, src, mask, f_cap, live_mask, 0,
        now, w_max, delete=False)
    out, new = emit_new(arrays, dist, adj, now, finals_mask, windows)
    return out, new, rounds, qrounds, fstats, syncs


def _valid_before(arrays: BatchedEngineArrays, ts_now, finals_mask, windows):
    """The delete dispatch's clock, thresholds and validity before the
    delete: ``(now, low, valid_before)``."""
    t0 = obs.on and obs.now()
    now = torch.maximum(arrays.now, ts_now)
    low = now - windows
    valid_before = batched_valid_pairs(arrays.dist, finals_mask, low)
    if t0:
        obs.add("executor.emit", t0)
    return now, low, valid_before


def _invalidated(dist, finals_mask, low, valid_before) -> torch.Tensor:
    """The pairs valid before the delete and not after it."""
    t0 = obs.on and obs.now()
    invalidated = valid_before & ~batched_valid_pairs(dist, finals_mask, low)
    if t0:
        obs.add("executor.emit", t0)
    return invalidated


def _delete(arrays: BatchedEngineArrays, src, dst, lab, mask, ts_now,
            btt: BatchedTransitionTable, finals_mask, windows, live_mask,
            w_max, backend: BackendLike = None,
            host: Optional[HostBatch] = None):
    """Explicit deletion (negative tuple): clear adjacency entries and
    recompute every query's closure from scratch. Returns
    ``(arrays, invalidated, rounds, query_rounds, host_syncs)``."""
    now, low, valid_before = _valid_before(arrays, ts_now, finals_mask, windows)
    adj = drop_batch(arrays, src, dst, lab, mask, host)
    if isinstance(arrays.dist, RowSparseDist):
        dist0 = rsd_empty_like(arrays.dist)
    else:
        dist0 = arrays.dist.fill_(NEG_INF)  # from scratch, in place
    dist, rounds, qrounds, syncs = _closure(
        dist0, adj, btt, backend, 0, live_mask, now, w_max)
    invalidated = _invalidated(dist, finals_mask, low, valid_before)
    return (BatchedEngineArrays(adj, dist, arrays.emitted, now),
            invalidated, rounds, qrounds, syncs)


def _delete_frontier(arrays: BatchedEngineArrays, src, dst, lab, mask,
                     ts_now, btt: BatchedTransitionTable, finals_mask,
                     windows, live_mask, w_max, backend: BackendLike = None,
                     f_cap: int = 32, host: Optional[HostBatch] = None):
    """Cone-seeded deletion: :func:`_delete` with only the rows whose
    derivations can pass through the dropped edges (the cone, on the
    pre-delete state) cleared and re-derived; cone overflow falls back to
    the dense from-scratch loop. Returns ``(arrays, invalidated, rounds,
    query_rounds, frontier_stats, host_syncs)``."""
    now, low, valid_before = _valid_before(arrays, ts_now, finals_mask, windows)
    adj = drop_batch(arrays, src, dst, lab, mask, host)
    dist, rounds, qrounds, fstats, syncs = _frontier(
        arrays.dist, adj, btt, backend, src, mask, f_cap, live_mask, 0,
        now, w_max, delete=True)
    invalidated = _invalidated(dist, finals_mask, low, valid_before)
    return (BatchedEngineArrays(adj, dist, arrays.emitted, now),
            invalidated, rounds, qrounds, fstats, syncs)


def _expire(arrays: BatchedEngineArrays, tau, max_window):
    """Lazy expiration at slide boundaries: drop adjacency entries at or
    below ``now - max_window`` and report per-slot liveness. dist needs no
    update (stale entries fall below each query's read-time threshold)."""
    now = torch.maximum(arrays.now, tau)
    low = now - max_window
    if isinstance(arrays.adj, EllAdjacency):
        adj = ell_expire(arrays.adj, low)
        incident = ell_incident(adj)
    else:
        adj = arrays.adj.masked_fill_(~(arrays.adj > low), NEG_INF)
        incident = torch.maximum(adj.amax(dim=(0, 2)), adj.amax(dim=(0, 1)))
    live = incident > low
    return BatchedEngineArrays(adj, arrays.dist, arrays.emitted, now), live


def _clear_slots(arrays: BatchedEngineArrays, slots: torch.Tensor):
    """Reset rows/cols of recycled slots (-inf / False) for all queries,
    in place on the dense tensors and the row-sparse leaves."""
    n = arrays.emitted.shape[1]
    dead = torch.zeros((n,), dtype=torch.bool, device=slots.device)
    dead.index_fill_(0, slots, True)
    if isinstance(arrays.adj, EllAdjacency):
        adj = ell_clear_slots(arrays.adj, dead)
    else:
        adj = arrays.adj.index_fill_(1, slots, NEG_INF).index_fill_(2, slots,
                                                                   NEG_INF)
    if isinstance(arrays.dist, RowSparseDist):
        dist = rsd_clear_slots(arrays.dist, dead)
    else:
        dist = arrays.dist.index_fill_(1, slots, NEG_INF).index_fill_(
            2, slots, NEG_INF)
    emitted = arrays.emitted.index_fill_(1, slots, False).index_fill_(2, slots, False)
    return BatchedEngineArrays(adj, dist, emitted, arrays.now)


# ---------------------------------------------------------------------------
# Executor = the single-device implementation
# ---------------------------------------------------------------------------


class Executor:
    """Device-facing half of :class:`~repro_torch.core.engine.BatchedDenseRPQEngine`:
    owns the :class:`BatchedEngineArrays`, every dispatch over them and
    the round and frontier accounting. ``device=None`` means the CUDA card
    and raises without one. ``dist_layout="row_sparse"`` keeps per-row
    slot sets of ``dist_cap`` entries and an overflow table of
    ``dist_ovf_cap`` rows (None: sized at first placement), with the
    reference's host budget, drains and re-packs."""

    q_multiple: int = 1
    n_multiple: int = 1

    def __init__(self, backend: BackendLike = None,
                 frontier: str = "off", frontier_cap: int = 32,
                 adj_layout: str = "dense", ell_cap: int = 8,
                 spill_cap: int = 256,
                 dist_layout: str = "dense", dist_cap: int = 16,
                 dist_ovf_cap: Optional[int] = None,
                 device: DeviceLike = None):
        check_options(frontier=frontier, adj_layout=adj_layout,
                      dist_layout=dist_layout)
        for name, value in (("frontier_cap", frontier_cap),
                            ("ell_cap", ell_cap), ("spill_cap", spill_cap),
                            ("dist_cap", dist_cap),
                            ("dist_ovf_cap",
                             1 if dist_ovf_cap is None else dist_ovf_cap)):
            if value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        self.device = resolve_device(device)
        self.backend: Backend = resolve_backend(backend)
        #: adjacency representation ("dense" | "ell"); results are layout-
        #: independent, memory and the seed term are not
        self.adj_layout = adj_layout
        #: dist representation ("dense" | "row_sparse"); results are
        #: layout-independent, memory and the emit scan are not
        self.dist_layout = dist_layout
        #: per-(q, x) slot capacity, pow2; grows x2 at overflow drains and
        #: whenever a pack finds a fuller row
        self.dist_cap = _next_pow2(dist_cap) if dist_cap > 1 else 1
        #: overflow-table rows; None = sized at first placement
        self.dist_ovf_cap = (_next_pow2(dist_ovf_cap)
                             if dist_ovf_cap is not None else None)
        self._dist_budget = 0     # claim bound since the last drain
        self._dist_repacks = 0
        self._dist_drains = 0
        self._dist_lost = 0       # host view, refreshed at drains
        self._dist_live_entries: Optional[int] = None
        #: per-(label, u) degree capacity, pow2; grows x2 at spill drains
        self.ell_cap = _next_pow2(ell_cap) if ell_cap > 1 else 1
        #: spill-ring capacity; the budget drains before it can fill
        self.spill_cap = _next_pow2(spill_cap)
        self._spill_budget = 0    # inserts dispatched since the last drain
        self._ell_repacks = 0
        self._ell_spill_drains = 0
        self._ell_live_edges: Optional[int] = None  # snapshot at last repack
        #: "off" = dense dispatch only, "on" = frontier dispatch at a fixed
        #: capacity, "auto" = frontier whose capacity grows x2 when overflow
        #: fallbacks are flushed
        self.frontier = frontier
        self.frontier_cap = _next_pow2(frontier_cap) if frontier_cap > 1 else 1
        self.steps = 0  # ingest/delete dispatches
        self._arrays: Optional[BatchedEngineArrays] = None
        # (rounds, query_rounds device tensor, n_live, FrontierStats | None,
        # n_slots, is_delete) per dispatch, folded in at _flush_counts
        self._pending_counts: List[Tuple[int, torch.Tensor, int, object, int,
                                         bool]] = []
        self._rounds_total = 0
        self._query_rounds_total = 0
        self._unmasked_query_rounds_total = 0
        self._frontier_dispatches = 0
        self._frontier_fallbacks = 0
        self._frontier_rows_relaxed = 0
        self._frontier_dense_row_equiv = 0
        self._frontier_seed_rows = 0
        self._frontier_max_lane_rows = 0
        self._frontier_growth_mark = 0
        self._frontier_delete_dispatches = 0
        self._frontier_delete_fallbacks = 0
        self._ell_contractions_total = 0
        #: blocking reads of the closure loops (one per round) and of the
        #: frontier fallback decision (one per frontier dispatch)
        self.host_syncs = 0

    # -- state ---------------------------------------------------------------

    def init_state(self, n_slots: int, n_label_slots: int, q_cap: int, k: int) -> None:
        """Empty state. The row-sparse dist is made empty directly: the
        leaves and capacities the reference's pack of an all -inf slab
        gives, without the (Q, N, N, K) slab."""
        dist = None
        if self.dist_layout == "row_sparse":
            self._size_ovf_table(q_cap, n_slots)
            self._dist_budget = 0
            dist = rsd_from_numpy(rsd_empty_np(q_cap, n_slots, k, self.dist_cap,
                                               self.dist_ovf_cap), self.device)
        arrays = init_batched_arrays(n_slots, n_label_slots, q_cap, k,
                                     self.device, dist)
        if self.adj_layout == "ell":
            arrays = arrays._replace(adj=self._pack_device(arrays.adj))
        self.set_arrays(arrays)

    @property
    def arrays(self) -> BatchedEngineArrays:
        return self._arrays

    def set_arrays(self, arrays: BatchedEngineArrays) -> None:
        self._arrays = arrays

    def place(self, state: Dict[str, object]) -> None:
        """(Re)place host arrays (numpy) as this executor's device state —
        the counterpart of the JAX executor's ``place``. ``adj`` and
        ``dist`` are the canonical dense slabs; an ELL executor packs the
        adjacency (growing ``ell_cap`` x2 until the live max degree fits), a
        row-sparse one the dist (growing ``dist_cap`` likewise)."""
        def put(x, dtype):
            return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

        self.set_arrays(BatchedEngineArrays(
            self.pack_adj(state["adj"]),
            self.pack_dist(state["dist"]),
            put(state["emitted"], torch.bool),
            put(np.float32(state["now"]), torch.float32).reshape(()),
        ))

    def pack_adj(self, adj):
        """Host dense slab -> device adjacency in this executor's layout
        (ELL packs after growing ``ell_cap`` x2 until the live max degree
        fits, so a pack never spills)."""
        adj_np = np.asarray(adj, np.float32)
        if self.adj_layout == "ell":
            need = int((adj_np > NEG_INF).sum(axis=-1).max()) if adj_np.size \
                else 0
            while self.ell_cap < need:
                self.ell_cap *= 2
            self._spill_budget = 0
            return from_numpy(pack_ell(adj_np, self.ell_cap, self.spill_cap),
                              self.device)
        return torch.tensor(adj_np, dtype=torch.float32, device=self.device)

    def _size_ovf_table(self, q: int, n: int) -> None:
        """The reference's one-time table sizing: room for every row at
        small scale, clamped at 4096 rows (the table's dense rows are
        N*K wide)."""
        if self.dist_ovf_cap is None:
            self.dist_ovf_cap = _next_pow2(min(max(q * n, 64), 4096))

    def pack_dist(self, dist):
        """Host dense ``(Q, N, N, K)`` slab -> device dist in this
        executor's layout (see :meth:`_pack_dist_device`)."""
        dense = torch.tensor(np.asarray(dist, np.float32), device=self.device)
        if self.dist_layout == "row_sparse":
            return self._pack_dist_device(dense)
        return dense

    def _pack_dist_device(self, dense: torch.Tensor) -> RowSparseDist:
        """Row-sparse pack of a dense slab on the device, after growing
        ``dist_cap`` x2 until the fullest row fits its slots (one host
        read), so a pack never routes a row to the overflow table: the
        leaves of the reference's host ``pack_rows``."""
        q, n = dense.shape[0], dense.shape[1]
        need = (int(device_get((dense > NEG_INF).reshape(q, n, -1).sum(-1)
                               .max())) if dense.numel() else 0)
        while self.dist_cap < need:
            self.dist_cap *= 2
        self._size_ovf_table(q, n)
        self._dist_budget = 0
        return rsd_from_dense(dense, self.dist_cap, self.dist_ovf_cap)

    def load_dist(self, sd: RowSparseDist, budget: int = 0) -> None:
        """Take ``sd`` as the dist, with its slot and table capacities and
        ``budget`` table claims made since the last drain."""
        self.dist_cap, self.dist_ovf_cap = sd.dist_cap, sd.ovf_cap
        self._dist_budget = int(budget)
        self._arrays = self._arrays._replace(dist=sd)

    def _pack_device(self, dense: torch.Tensor) -> EllAdjacency:
        """:meth:`pack_adj` for a dense slab already on the device (growth
        and re-packs keep the state on the card)."""
        need = int(device_get((dense > NEG_INF).sum(dim=-1).max())) \
            if dense.numel() else 0
        while self.ell_cap < need:
            self.ell_cap *= 2
        self._spill_budget = 0
        return pack_ell_dense(dense, self.ell_cap, self.spill_cap)

    def dense_adj(self) -> torch.Tensor:
        """The adjacency in canonical dense form regardless of layout."""
        a = self._arrays.adj
        if isinstance(a, EllAdjacency):
            return ell_to_dense(a)
        return a

    def dense_dist(self) -> torch.Tensor:
        """The dist in canonical dense ``(Q, N, N, K)`` form regardless of
        layout (a row-sparse dist is densified: maintenance paths only)."""
        d = self._arrays.dist
        if isinstance(d, RowSparseDist):
            return rsd_to_dense(d)
        return d

    def dense_emitted(self) -> torch.Tensor:
        """The emitted pairs as one ``(Q, N, N)`` tensor."""
        return self._arrays.emitted

    def lane_dist(self, lanes: Sequence[int]) -> torch.Tensor:
        """The dense dist of the given lanes, ``(len(lanes), N, N, K)``
        (the engine's conflict probe)."""
        sel = device_put(lanes, self.device, "probe_lanes", torch.int64)
        return self.dense_dist().index_select(0, sel)

    @property
    def now(self) -> torch.Tensor:
        """The stream clock, a () float32 tensor on the device."""
        return self._arrays.now

    @property
    def adj_shape(self) -> Tuple[int, int, int]:
        """Logical dense ``(L, N, N)`` adjacency shape regardless of layout."""
        a = self._arrays.adj
        if isinstance(a, EllAdjacency):
            return (a.n_labels, a.n_slots, a.n_slots)
        return tuple(a.shape)

    @property
    def dist_shape(self) -> Tuple[int, int, int, int]:
        """Logical dense ``(Q, N, N, K)`` dist shape regardless of layout."""
        d = self._arrays.dist
        if isinstance(d, RowSparseDist):
            return (d.n_lanes, d.n_slots, d.n_slots, d.k)
        return tuple(d.shape)

    def grow(self, *, n_slots: Optional[int] = None, q_cap: Optional[int] = None,
             k: Optional[int] = None, n_label_slots: Optional[int] = None) -> None:
        """Grow device state (append-only padding: -inf / False); existing
        lanes, labels, slots and states keep their indices. Never shrinks.
        Grows on the device through the canonical dense slabs, as the
        reference does: an ELL adjacency re-packs at the new shape (the
        ring drains as a side effect), a row-sparse dist re-packs with the
        table empty."""
        l_old, n_old, _ = self.adj_shape
        q_old, _, _, k_old = self.dist_shape
        n_new = max(n_slots or 0, n_old)
        l_new = max(n_label_slots or 0, l_old)
        q_new = max(q_cap or 0, q_old)
        k_new = max(k or 0, k_old)
        if (n_new, l_new, q_new, k_new) == (n_old, l_old, q_old, k_old):
            return
        grown = init_batched_arrays(n_new, l_new, q_new, k_new, self.device)
        grown.adj[:l_old, :n_old, :n_old] = self.dense_adj()
        grown.dist[:q_old, :n_old, :n_old, :k_old] = self.dense_dist()
        grown.emitted[:q_old, :n_old, :n_old] = self.dense_emitted()
        grown = grown._replace(now=self.now)
        if self.adj_layout == "ell":
            grown = grown._replace(adj=self._pack_device(grown.adj))
        if self.dist_layout == "row_sparse":
            grown = grown._replace(dist=self._pack_dist_device(grown.dist))
        self.set_arrays(grown)

    # -- dispatches ----------------------------------------------------------

    def _batch(self, *arrays):
        t0 = obs.on and obs.now()
        out = [torch.as_tensor(np.asarray(x)).to(self.device, non_blocking=True)
               for x in arrays]
        if t0:
            obs.add("executor.upload", t0)
        return out

    def ingest_batch(self, src, dst, lab, ts, mask, ts_floor: float,
                     tables: QueryTables) -> torch.Tensor:
        """One ingest dispatch for the whole query group. Returns the
        per-query NEW-validity matrix (Q, N, N) as a device tensor. With
        ``frontier != "off"`` the closure is frontier-restricted (dense
        fallback on overflow; results are bit-identical either way)."""
        t0 = obs.on and obs.now()
        if self.adj_layout == "ell":
            self._reserve_spill(len(src))
        if self.dist_layout == "row_sparse":
            self._reserve_dist(self.frontier != "off")
        host = HostBatch(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                         np.asarray(lab, np.int64), np.asarray(mask, bool))
        src_t, dst_t, lab_t, ts_t, mask_t = self._batch(
            host.src, host.dst, host.lab, np.asarray(ts, np.float32), host.mask)
        args = (self._arrays, src_t, dst_t, lab_t, ts_t, mask_t,
                _f32(ts_floor, self.device), tables.btt, tables.finals_mask,
                tables.windows, tables.live_mask,
                _f32(tables.max_window, self.device))
        fstats = None
        if self.frontier != "off":
            self._arrays, new, rounds, qrounds, fstats, syncs = _ingest_frontier(
                *args, backend=self.backend, f_cap=self.frontier_cap, host=host)
        else:
            self._arrays, new, rounds, qrounds, syncs = _ingest(
                *args, backend=self.backend, host=host)
        self._account(rounds, qrounds, tables, syncs, fstats)
        self.steps += 1
        if t0:
            obs.add("executor.dispatch", t0)
        return new

    def delete_batch(self, src, dst, lab, mask, ts_now: float,
                     tables: QueryTables) -> torch.Tensor:
        """Explicit deletion dispatch; returns the invalidated pairs
        (Q, N, N) as a device tensor. With ``frontier != "off"`` only the
        deleted edges' cone is cleared and re-derived."""
        t0 = obs.on and obs.now()
        if self.dist_layout == "row_sparse":
            self._reserve_dist(self.frontier != "off")
        host = HostBatch(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                         np.asarray(lab, np.int64), np.asarray(mask, bool))
        src_t, dst_t, lab_t, mask_t = self._batch(host.src, host.dst,
                                                  host.lab, host.mask)
        args = (self._arrays, src_t, dst_t, lab_t, mask_t,
                _f32(ts_now, self.device), tables.btt, tables.finals_mask,
                tables.windows, tables.live_mask,
                _f32(tables.max_window, self.device))
        fstats = None
        if self.frontier != "off":
            self._arrays, invalidated, rounds, qrounds, fstats, syncs = \
                _delete_frontier(*args, backend=self.backend,
                                 f_cap=self.frontier_cap, host=host)
        else:
            self._arrays, invalidated, rounds, qrounds, syncs = _delete(
                *args, backend=self.backend, host=host)
        self._account(rounds, qrounds, tables, syncs, fstats, is_delete=True)
        self.steps += 1
        if t0:
            obs.add("executor.dispatch", t0)
        return invalidated

    def relax(self, tables: QueryTables,
              query_mask: Optional[np.ndarray] = None) -> None:
        """Run the batched closure to fixpoint in place (lane seeding at
        registration, or any re-derivation); always the dense loop (a
        row-sparse dist takes the densify round trip)."""
        t0 = obs.on and obs.now()
        if self.dist_layout == "row_sparse":
            self._reserve_dist(False)
        a = self._arrays
        mask = tables.live_mask if query_mask is None else torch.as_tensor(
            np.asarray(query_mask, bool)).to(self.device)
        dist, rounds, qrounds, syncs = _closure(
            a.dist, a.adj, tables.btt, self.backend, 0, mask, a.now,
            _f32(tables.max_window, self.device))
        self._arrays = a._replace(dist=dist)
        self._account(rounds, qrounds, tables, syncs)
        if t0:
            obs.add("executor.dispatch", t0)

    def emit(self, tables: QueryTables) -> torch.Tensor:
        """(Q, N, N) bool device tensor of pairs valid over each query's
        window at the current stream clock."""
        a = self._arrays
        return batched_valid_pairs(a.dist, tables.finals_mask,
                                   a.now - tables.windows)

    def expire(self, tau: float, max_window: float) -> np.ndarray:
        t0 = obs.on and obs.now()
        self._arrays, live = _expire(self._arrays, _f32(tau, self.device),
                                     _f32(max_window, self.device))
        live = device_get(live, "expire")
        if t0:
            obs.add("executor.expire", t0)
        return live

    def clear_slots(self, slots: Sequence[int]) -> None:
        idx = device_put(list(slots), self.device, "slots", torch.int64)
        self._arrays = _clear_slots(self._arrays, idx)

    def clear_lane(self, lane: int) -> None:
        a = self._arrays
        if isinstance(a.dist, RowSparseDist):
            rsd_clear_lane(a.dist, lane)
        else:
            a.dist[lane] = NEG_INF
        a.emitted[lane] = False

    def set_lane_emitted(self, lane: int, valid_lane: torch.Tensor) -> None:
        self._arrays.emitted[lane] = valid_lane

    def advance_clock(self, ts: float) -> None:
        a = self._arrays
        self._arrays = a._replace(now=torch.maximum(a.now, _f32(ts, self.device)))

    # -- ELL spill budget ----------------------------------------------------
    #
    # Each ingest dispatch of width B can append at most B ring entries, so
    # the host tracks the appends since the last drain and reads the ring
    # cursor BEFORE a dispatch could overflow it. A drain that finds the
    # ring occupied grows ``ell_cap`` x2 toward the true max degree and
    # re-packs (which empties the ring); one that finds it empty resets the
    # budget. Both reads are explicit syncs (device_get), off the
    # per-event path: streams without degree growth never pay them.

    def _reserve_spill(self, b: int) -> None:
        t0 = obs.on and obs.now()
        bneed = _next_pow2(2 * max(b, 1))
        grew = False
        while self.spill_cap < bneed:
            self.spill_cap *= 2
            grew = True
        if grew:
            self._repack_ell()
        elif self._spill_budget + b > self.spill_cap:
            self._drain_spill()
        self._spill_budget += b
        if t0:
            obs.add("executor.spill", t0)

    def _drain_spill(self) -> None:
        self._ell_spill_drains += 1
        ptr = int(device_get(self._arrays.adj.spill_ptr, "spill"))
        if ptr > 0:
            need = int(device_get(ell_max_degree(self._arrays.adj), "spill"))
            while self.ell_cap < need:
                self.ell_cap *= 2
            self._repack_ell()
        else:
            self._spill_budget = 0

    def _repack_ell(self) -> None:
        """Re-pack at the current capacities on the device: the live
        entries (ring folded in, then emptied) into rows, growing
        ``ell_cap`` to the max degree. Growth and compaction reuse this;
        dist/emitted stay resident."""
        self._arrays = self._arrays._replace(adj=self._repack(self._arrays.adj))
        self._ell_repacks += 1

    def _repack(self, ell: EllAdjacency) -> EllAdjacency:
        """:func:`pack_ell_dense` of ``ell``'s canonical slab, from its
        live entries (no (L, N, N) slab): the span ``executor.repack``
        around its three reads, each ``sync.repack``."""
        t0 = obs.on and obs.now()
        keys, ts = ell_live_entries(ell)
        need = ell_entries_degree(keys, ell.n_labels, ell.n_slots)
        while self.ell_cap < need:
            self.ell_cap *= 2
        self._spill_budget = 0
        self._ell_live_edges = int(keys.numel())
        out = pack_ell_entries(keys, ts, ell.n_labels, ell.n_slots,
                               self.ell_cap, self.spill_cap)
        if t0:
            obs.add("executor.repack", t0)
        return out

    @property
    def adjacency_stats(self) -> Dict[str, object]:
        """Adjacency-representation telemetry (host-known values only).
        ``live_edges`` and ``occupancy`` are snapshots from the last
        re-pack (None before one); ``adj_bytes`` is the device footprint
        of the current representation."""
        a = self._arrays.adj if self._arrays is not None else None
        if isinstance(a, EllAdjacency):
            slot_cells = a.n_labels * a.n_slots * a.ell_cap
            adj_bytes = sum(x.numel() * x.element_size() for x in a)
        else:
            slot_cells = a.numel() if a is not None else 0
            adj_bytes = slot_cells * 4
        return {
            "layout": self.adj_layout,
            "ell_cap": self.ell_cap,
            "spill_cap": self.spill_cap,
            "repacks": self._ell_repacks,
            "spill_drains": self._ell_spill_drains,
            "live_edges": self._ell_live_edges,
            "slot_cells": slot_cells,
            "adj_bytes": adj_bytes,
            "occupancy": (self._ell_live_edges / slot_cells
                          if self._ell_live_edges is not None and slot_cells
                          else None),
        }

    # -- row-sparse dist overflow budget -------------------------------------
    #
    # The ELL spill budget at row granularity: a frontier dispatch can claim
    # at most its frontier rows, a dense round trip up to every row, so the
    # host tracks a bound on table claims since the last drain and reads the
    # claim cursor BEFORE the bound crosses the table's capacity. A drain
    # that finds claims grows ``dist_cap`` x2 toward the fullest row and
    # re-packs (rsd_grow_repack: no densify), which empties the table; one
    # that finds it empty resets the budget. Rows lost with the table full
    # are counted (``dist_stats["lost"]``), never silent.

    def _reserve_dist(self, frontier: bool) -> None:
        t0 = obs.on and obs.now()
        q, n = self.dist_shape[0], self.dist_shape[1]
        w = q * min(self.frontier_cap, n) if frontier else q * n
        w = min(w, self.dist_ovf_cap)
        if self._dist_budget + w > self.dist_ovf_cap:
            self._drain_dist()
        self._dist_budget += w
        if t0:
            obs.add("executor.spill", t0)

    def _drain_dist(self) -> None:
        self._dist_drains += 1
        d = self._arrays.dist
        ptr, lost = (int(x) for x in device_get(
            torch.stack([d.ovf_ptr, d.lost]), "drain"))
        self._dist_lost = lost
        if ptr > 0:
            need = int(device_get(rsd_row_counts(d).max(), "drain"))
            while self.dist_cap < need:
                self.dist_cap *= 2
            self._repack_dist()
        else:
            self._dist_budget = 0

    def _repack_dist(self) -> None:
        """Re-pack at the current capacities without densifying: table
        rows that now fit move into their slots, the table empties; adj
        and emitted stay resident."""
        sd = rsd_grow_repack(self._arrays.dist, self.dist_cap, self.dist_ovf_cap)
        self._arrays = self._arrays._replace(dist=sd)
        self._dist_repacks += 1
        self._dist_live_entries = int(device_get(rsd_live_entries(sd), "drain"))
        self._dist_budget = 0

    @property
    def dist_stats(self) -> Dict[str, object]:
        """Dist-representation telemetry (host-known values only).
        ``live_entries`` and ``occupancy`` are snapshots from the last
        re-pack (None before one); ``lost`` is the host's view from the
        last drain; ``dist_bytes`` is the device footprint of the current
        representation."""
        d = self._arrays.dist if self._arrays is not None else None
        if isinstance(d, RowSparseDist):
            slot_cells = d.n_lanes * d.n_slots * d.dist_cap
            dist_bytes = sum(x.numel() * x.element_size() for x in d)
        else:
            slot_cells = d.numel() if d is not None else 0
            dist_bytes = slot_cells * 4
        return {
            "layout": self.dist_layout,
            "dist_cap": self.dist_cap,
            "ovf_cap": self.dist_ovf_cap,
            "repacks": self._dist_repacks,
            "drains": self._dist_drains,
            "lost": self._dist_lost,
            "live_entries": self._dist_live_entries,
            "slot_cells": slot_cells,
            "dist_bytes": dist_bytes,
            "occupancy": (self._dist_live_entries / slot_cells
                          if self._dist_live_entries is not None and slot_cells
                          else None),
        }

    # -- round and frontier accounting ---------------------------------------

    def _account(self, rounds: int, qrounds: torch.Tensor, tables: QueryTables,
                 syncs: int, fstats=None, is_delete: bool = False) -> None:
        self.host_syncs += syncs
        n = self.dist_shape[1] if self._arrays is not None else 0
        self._count_ell(rounds, tables, fstats, n)
        self._pending_counts.append(
            (rounds, qrounds, tables.n_live, fstats, n, is_delete))
        # "auto" flushes more eagerly: its x2 capacity growth reads the
        # flushed overflow telemetry (the reference's cadence)
        limit = 64 if self.frontier == "auto" else 256
        if len(self._pending_counts) >= limit:
            self._flush_counts()

    def _count_ell(self, rounds: int, tables: QueryTables, fstats,
                   n: int) -> None:
        if self.adj_layout == "ell":
            # a frontier round contracts once, a dense round once per J chunk
            dense = fstats is None or fstats.fell_back
            per_round = (ell_round_launches(tables.btt.qidx.shape[0], n)
                         if dense else 1)
            self._ell_contractions_total += rounds * per_round

    def _flush_counts(self) -> None:
        t0 = obs.on and self._pending_counts and obs.now()
        for rounds, qrounds, n_live, fstats, n, is_delete in \
                self._pending_counts:
            self._consume_count(rounds, qrounds, n_live)
            self._consume_frontier(fstats, rounds, n_live, n, is_delete)
        self._pending_counts.clear()
        self._maybe_grow_frontier()
        if t0:
            obs.add("executor.flush", t0)

    def _consume_count(self, rounds: int, qrounds: torch.Tensor,
                       n_live: int) -> None:
        self._rounds_total += rounds
        self._query_rounds_total += int(device_get(qrounds.sum(), "count"))
        self._unmasked_query_rounds_total += n_live * rounds

    def _consume_frontier(self, fstats, rounds: int, n_live: int, n: int,
                          is_delete: bool = False) -> None:
        if fstats is None:
            return
        self._frontier_dispatches += 1
        fell = int(fstats.fell_back)
        self._frontier_fallbacks += fell
        if is_delete:
            self._frontier_delete_dispatches += 1
            self._frontier_delete_fallbacks += fell
        self._frontier_rows_relaxed += fstats.rows_relaxed
        self._frontier_seed_rows += fstats.seed_rows
        self._frontier_max_lane_rows = max(self._frontier_max_lane_rows,
                                           fstats.max_lane_rows)
        # what a dense loop of the same dispatch relaxes: every live lane
        # rides every round over all N rows
        self._frontier_dense_row_equiv += n_live * n * rounds

    def _maybe_grow_frontier(self) -> None:
        """``frontier="auto"``: grow the capacity x2 toward the largest
        observed lane frontier whenever new overflow fallbacks were
        flushed."""
        if self.frontier != "auto":
            return
        if self._frontier_fallbacks <= self._frontier_growth_mark:
            return
        self._frontier_growth_mark = self._frontier_fallbacks
        n = (self.dist_shape[1]
             if self._arrays is not None else self._frontier_max_lane_rows)
        limit = _next_pow2(n)
        target = min(_next_pow2(max(self._frontier_max_lane_rows,
                                    self.frontier_cap * 2)), limit)
        while self.frontier_cap < target:
            self.frontier_cap *= 2

    @property
    def frontier_stats(self) -> Dict[str, object]:
        """Aggregate frontier telemetry: dispatches (ingest and delete; the
        delete split also on its own), overflow fallbacks, rows relaxed vs
        the dense-loop row equivalent, seed rows and the current capacity.
        ``occupancy`` is None when no dense-row-equivalent work was seen."""
        self._flush_counts()
        dense_rows = self._frontier_dense_row_equiv
        return {
            "mode": self.frontier,
            "cap": self.frontier_cap,
            "dispatches": self._frontier_dispatches,
            "fallbacks": self._frontier_fallbacks,
            "delete_dispatches": self._frontier_delete_dispatches,
            "delete_fallbacks": self._frontier_delete_fallbacks,
            "rows_relaxed": self._frontier_rows_relaxed,
            "dense_row_equiv": dense_rows,
            "seed_rows": self._frontier_seed_rows,
            "max_lane_rows": self._frontier_max_lane_rows,
            "occupancy": (self._frontier_rows_relaxed / dense_rows
                          if dense_rows else None),
        }

    @property
    def ell_contractions_total(self) -> int:
        """ELL contractions the closure rounds ran, kernel B5's launches on
        the card: one per frontier round, one per J chunk of a dense round
        (:func:`~repro_torch.core.semiring.ell_round_launches`); 0 on the
        dense adjacency."""
        return self._ell_contractions_total

    @property
    def rounds_total(self) -> int:
        """Global closure iterations (each dispatch's loop runs until its
        slowest participating query converges)."""
        self._flush_counts()
        return self._rounds_total

    @property
    def query_rounds_total(self) -> int:
        """Sum over queries of ACTIVE rounds (per-query convergence mask)."""
        self._flush_counts()
        return self._query_rounds_total

    @property
    def unmasked_query_rounds_total(self) -> int:
        """What the same dispatches would cost with every live lane riding
        to the global fixpoint."""
        self._flush_counts()
        return self._unmasked_query_rounds_total


class LocalExecutor(Executor):
    """Single-device executor (the mesh executor over a grid of devices is
    :class:`repro_torch.distributed.executor.MeshExecutor`)."""
