"""Executor layer: everything device-facing of the batched dense engine —
the counterpart of ``repro.core.executor`` for the dense layouts with
``frontier="off"``.

The engine (:mod:`repro_torch.core.engine`) is pure orchestration. The
device state (:class:`BatchedEngineArrays`, torch tensors on one device)
and every dispatch over it live behind :class:`Executor`:

    ingest_batch / delete_batch   one dispatch per micro-batch
    relax                         closure to fixpoint in place
    emit                          per-query window-valid pairs (device)
    arrays / place / grow         state access, (re)placement, growth
    expire / clear_slots / ...    maintenance

The step functions (:func:`apply_batch`, :func:`emit_new`, :func:`_ingest`,
:func:`_delete`, :func:`_expire`, :func:`_clear_slots`) keep the JAX
package's names. They update the state tensors in place where the JAX
versions donate their input (``donate_argnums``): at N=2048 every copy of
dist is 0.8 GB.

Round accounting lives here too: ``rounds_total``, ``query_rounds_total``
and ``unmasked_query_rounds_total`` as in the JAX executor (the per-query
counts stay on the device and are read lazily), plus ``host_syncs``: the
closure loop's per-round reads of the changed flags, which the JAX
version does not need because its loop runs on the device.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, device_get, resolve_device
from .contraction import Backend, BackendLike, resolve_backend
from .semiring import NEG_INF, BatchedTransitionTable, _closure, batched_valid_pairs

FRONTIER_MODES = ("off", "on", "auto")
ADJ_LAYOUTS = ("dense", "ell")
DIST_LAYOUTS = ("dense", "row_sparse")

#: options of the JAX executor the port does not run yet, with the
#: ROADMAP item that brings each
_NOT_PORTED = {
    "frontier": ("off", "ROADMAP A6 (frontier-restricted ingest)"),
    "adj_layout": ("dense", "ROADMAP A8 (ELL adjacency)"),
    "dist_layout": ("dense", "ROADMAP A9 (row-sparse dist)"),
}


def check_ported(**options) -> None:
    """Raise for an executor option whose non-default value is not ported
    (and for values the JAX package does not know either)."""
    known = {"frontier": FRONTIER_MODES, "adj_layout": ADJ_LAYOUTS,
             "dist_layout": DIST_LAYOUTS}
    for key, value in options.items():
        if value not in known[key]:
            raise ValueError(f"unknown {key} {value!r}; known: "
                             f"{', '.join(known[key])}")
        default, item = _NOT_PORTED[key]
        if value != default:
            raise NotImplementedError(
                f"{key}={value!r} is not yet ported ({item}); the port runs "
                f"{key}={default!r}")


class BatchedEngineArrays(NamedTuple):
    adj: torch.Tensor      # (L, N, N) f32 shared
    dist: torch.Tensor     # (Q, N, N, K) f32
    emitted: torch.Tensor  # (Q, N, N) bool
    now: torch.Tensor      # () f32


def init_batched_arrays(n_slots: int, n_labels: int, n_queries: int, k: int,
                        device: DeviceLike = None) -> BatchedEngineArrays:
    dev = resolve_device(device)
    return BatchedEngineArrays(
        adj=torch.full((n_labels, n_slots, n_slots), NEG_INF,
                       dtype=torch.float32, device=dev),
        dist=torch.full((n_queries, n_slots, n_slots, k), NEG_INF,
                        dtype=torch.float32, device=dev),
        emitted=torch.zeros((n_queries, n_slots, n_slots), dtype=torch.bool,
                            device=dev),
        now=torch.tensor(NEG_INF, dtype=torch.float32, device=dev),
    )


class QueryTables(NamedTuple):
    """Per-lane metadata the engine rebuilds at lifecycle events and the
    executor consumes at every dispatch (tensors on the engine's device;
    ``n_live`` and ``max_window`` are host values)."""

    btt: BatchedTransitionTable
    finals_mask: torch.Tensor  # (Q, K) bool
    windows: torch.Tensor      # (Q,) f32
    live_mask: torch.Tensor    # (Q,) bool
    n_live: int
    max_window: float = 0.0


def _f32(x, device: torch.device) -> torch.Tensor:
    """A host scalar as a float32 device scalar. The clock arithmetic
    (``now``, ``ts_floor``, ``now - windows``, the expiry threshold) stays
    in float32 tensors, as in the JAX version, so validity at the window
    boundary rounds exactly as the reference does."""
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# step functions (in place on the state tensors; see the module docstring)
# ---------------------------------------------------------------------------


def apply_batch(arrays: BatchedEngineArrays, src, dst, lab, ts, mask,
                ts_floor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ingest dispatch prologue: fold the masked batch into the
    adjacency (newest-timestamp max) and advance the stream clock.
    Returns ``(adj, now)``; ``adj`` is updated in place.

    A batch may hold one (label, src, dst) twice, and masked rows carry
    -inf: a scatter with ``amax`` keeps the newest timestamp, where an
    accumulating ``index_put_`` would add them."""
    eff_ts = torch.where(mask, ts, torch.full_like(ts, NEG_INF))
    adj = arrays.adj
    _, n, _ = adj.shape
    flat = (lab * n + src) * n + dst
    adj.view(-1).scatter_reduce_(0, flat, eff_ts, "amax", include_self=True)
    now = torch.maximum(arrays.now, torch.maximum(eff_ts.max(), ts_floor))
    return adj, now


def drop_batch(arrays: BatchedEngineArrays, src, dst, lab, mask) -> torch.Tensor:
    """The delete dispatch prologue: clear the masked batch's adjacency
    entries (in place). Returns the retained adjacency."""
    adj = arrays.adj
    _, n, _ = adj.shape
    flat = ((lab * n + src) * n + dst)[mask]
    adj.view(-1)[flat] = NEG_INF
    return adj


def emit_new(arrays: BatchedEngineArrays, dist, adj, now, finals_mask,
             windows) -> Tuple[BatchedEngineArrays, torch.Tensor]:
    """The ingest dispatch epilogue: per-query window validity at the new
    clock, diffed against the emitted pairs (``emitted`` is updated in
    place). Returns ``(new_arrays, new)``."""
    low = now - windows
    valid = batched_valid_pairs(dist, finals_mask, low)
    new = valid & ~arrays.emitted
    emitted = arrays.emitted.logical_or_(valid)
    return BatchedEngineArrays(adj, dist, emitted, now), new


def _ingest(arrays: BatchedEngineArrays, src, dst, lab, ts, mask, ts_floor,
            btt: BatchedTransitionTable, finals_mask, windows, live_mask,
            w_max, backend: BackendLike = None):
    """One ingest dispatch: fold the batch, close every live lane, emit.
    Returns ``(arrays, new, rounds, query_rounds, host_syncs)``."""
    adj, now = apply_batch(arrays, src, dst, lab, ts, mask, ts_floor)
    dist, rounds, qrounds, syncs = _closure(
        arrays.dist, adj, btt, backend, 0, live_mask, now, w_max)
    out, new = emit_new(arrays, dist, adj, now, finals_mask, windows)
    return out, new, rounds, qrounds, syncs


def _delete(arrays: BatchedEngineArrays, src, dst, lab, mask, ts_now,
            btt: BatchedTransitionTable, finals_mask, windows, live_mask,
            w_max, backend: BackendLike = None):
    """Explicit deletion (negative tuple): clear adjacency entries and
    recompute every query's closure from scratch. Returns
    ``(arrays, invalidated, rounds, query_rounds, host_syncs)``."""
    now = torch.maximum(arrays.now, ts_now)
    low = now - windows
    valid_before = batched_valid_pairs(arrays.dist, finals_mask, low)
    adj = drop_batch(arrays, src, dst, lab, mask)
    dist0 = arrays.dist.fill_(NEG_INF)      # from scratch, in place
    dist, rounds, qrounds, syncs = _closure(
        dist0, adj, btt, backend, 0, live_mask, now, w_max)
    valid_after = batched_valid_pairs(dist, finals_mask, low)
    invalidated = valid_before & ~valid_after
    return (BatchedEngineArrays(adj, dist, arrays.emitted, now),
            invalidated, rounds, qrounds, syncs)


def _expire(arrays: BatchedEngineArrays, tau, max_window):
    """Lazy expiration at slide boundaries: drop adjacency entries at or
    below ``now - max_window`` (in place) and report per-slot liveness.
    dist needs no update (stale entries fall below each query's read-time
    threshold)."""
    now = torch.maximum(arrays.now, tau)
    low = now - max_window
    adj = arrays.adj.masked_fill_(~(arrays.adj > low), NEG_INF)
    incident = torch.maximum(adj.amax(dim=(0, 2)), adj.amax(dim=(0, 1)))
    live = incident > low
    return BatchedEngineArrays(adj, arrays.dist, arrays.emitted, now), live


def _clear_slots(arrays: BatchedEngineArrays, slots: torch.Tensor):
    """Reset rows/cols of recycled slots (-inf / False) for all queries,
    in place."""
    adj = arrays.adj.index_fill_(1, slots, NEG_INF).index_fill_(2, slots, NEG_INF)
    dist = arrays.dist.index_fill_(1, slots, NEG_INF).index_fill_(2, slots, NEG_INF)
    emitted = arrays.emitted.index_fill_(1, slots, False).index_fill_(2, slots, False)
    return BatchedEngineArrays(adj, dist, emitted, arrays.now)


# ---------------------------------------------------------------------------
# Executor = the single-device implementation
# ---------------------------------------------------------------------------


class Executor:
    """Device-facing half of :class:`~repro_torch.core.engine.BatchedDenseRPQEngine`:
    owns the :class:`BatchedEngineArrays`, every dispatch over them and
    the round accounting. ``device=None`` means the CUDA card and raises
    without one. The frontier and the sparse layouts are not ported yet:
    their options keep the JAX signature, any non-default value raises and
    names its ROADMAP item, and their capacities are ignored."""

    q_multiple: int = 1
    n_multiple: int = 1

    def __init__(self, backend: BackendLike = None,
                 frontier: str = "off", frontier_cap: int = 32,
                 adj_layout: str = "dense", ell_cap: int = 8,
                 spill_cap: int = 256,
                 dist_layout: str = "dense", dist_cap: int = 16,
                 dist_ovf_cap: Optional[int] = None,
                 device: DeviceLike = None):
        check_ported(frontier=frontier, adj_layout=adj_layout,
                     dist_layout=dist_layout)
        self.device = resolve_device(device)
        self.backend: Backend = resolve_backend(backend)
        self.steps = 0  # ingest/delete dispatches
        self._arrays: Optional[BatchedEngineArrays] = None
        # per-dispatch query-round tensors, read lazily so the dispatch
        # path adds no sync of its own
        self._pending_counts: List[torch.Tensor] = []
        self._rounds_total = 0
        self._query_rounds_total = 0
        self._unmasked_query_rounds_total = 0
        #: host reads of the closure loop's changed flags (one per round)
        self.host_syncs = 0

    # -- state ---------------------------------------------------------------

    def init_state(self, n_slots: int, n_label_slots: int, q_cap: int, k: int) -> None:
        self.set_arrays(init_batched_arrays(n_slots, n_label_slots, q_cap, k,
                                            self.device))

    @property
    def arrays(self) -> BatchedEngineArrays:
        return self._arrays

    def set_arrays(self, arrays: BatchedEngineArrays) -> None:
        self._arrays = arrays

    def place(self, state: Dict[str, object]) -> None:
        """(Re)place host arrays (numpy) as this executor's device state —
        the counterpart of the JAX executor's ``place``."""
        def put(x, dtype):
            return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

        self.set_arrays(BatchedEngineArrays(
            put(state["adj"], torch.float32),
            put(state["dist"], torch.float32),
            put(state["emitted"], torch.bool),
            put(np.float32(state["now"]), torch.float32).reshape(()),
        ))

    def dense_adj(self) -> torch.Tensor:
        return self._arrays.adj

    def dense_dist(self) -> torch.Tensor:
        return self._arrays.dist

    @property
    def adj_shape(self) -> Tuple[int, int, int]:
        return tuple(self._arrays.adj.shape)

    @property
    def dist_shape(self) -> Tuple[int, int, int, int]:
        return tuple(self._arrays.dist.shape)

    def grow(self, *, n_slots: Optional[int] = None, q_cap: Optional[int] = None,
             k: Optional[int] = None, n_label_slots: Optional[int] = None) -> None:
        """Grow device state (append-only padding: -inf / False); existing
        lanes, labels, slots and states keep their indices. Never shrinks.
        Grows on the device, with no host round trip."""
        a = self._arrays
        l_old, n_old, _ = a.adj.shape
        q_old, _, _, k_old = a.dist.shape
        n_new = max(n_slots or 0, n_old)
        l_new = max(n_label_slots or 0, l_old)
        q_new = max(q_cap or 0, q_old)
        k_new = max(k or 0, k_old)
        if (n_new, l_new, q_new, k_new) == (n_old, l_old, q_old, k_old):
            return
        grown = init_batched_arrays(n_new, l_new, q_new, k_new, self.device)
        grown.adj[:l_old, :n_old, :n_old] = a.adj
        grown.dist[:q_old, :n_old, :n_old, :k_old] = a.dist
        grown.emitted[:q_old, :n_old, :n_old] = a.emitted
        self.set_arrays(grown._replace(now=a.now))

    # -- dispatches ----------------------------------------------------------

    def _batch(self, *arrays):
        return [torch.as_tensor(np.asarray(x)).to(self.device, non_blocking=True)
                for x in arrays]

    def ingest_batch(self, src, dst, lab, ts, mask, ts_floor: float,
                     tables: QueryTables) -> torch.Tensor:
        """One ingest dispatch for the whole query group. Returns the
        per-query NEW-validity matrix (Q, N, N) as a device tensor."""
        src_t, dst_t, lab_t, ts_t, mask_t = self._batch(
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(lab, np.int64), np.asarray(ts, np.float32),
            np.asarray(mask, bool))
        self._arrays, new, rounds, qrounds, syncs = _ingest(
            self._arrays, src_t, dst_t, lab_t, ts_t, mask_t,
            _f32(ts_floor, self.device),
            tables.btt, tables.finals_mask, tables.windows, tables.live_mask,
            _f32(tables.max_window, self.device), backend=self.backend)
        self._account(rounds, qrounds, tables.n_live, syncs)
        self.steps += 1
        return new

    def delete_batch(self, src, dst, lab, mask, ts_now: float,
                     tables: QueryTables) -> torch.Tensor:
        """Explicit deletion dispatch; returns the invalidated pairs
        (Q, N, N) as a device tensor."""
        src_t, dst_t, lab_t, mask_t = self._batch(
            np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(lab, np.int64), np.asarray(mask, bool))
        self._arrays, invalidated, rounds, qrounds, syncs = _delete(
            self._arrays, src_t, dst_t, lab_t, mask_t,
            _f32(ts_now, self.device),
            tables.btt, tables.finals_mask, tables.windows, tables.live_mask,
            _f32(tables.max_window, self.device), backend=self.backend)
        self._account(rounds, qrounds, tables.n_live, syncs)
        self.steps += 1
        return invalidated

    def relax(self, tables: QueryTables,
              query_mask: Optional[np.ndarray] = None) -> None:
        """Run the batched closure to fixpoint in place (lane seeding at
        registration, or any re-derivation)."""
        a = self._arrays
        mask = tables.live_mask if query_mask is None else torch.as_tensor(
            np.asarray(query_mask, bool)).to(self.device)
        dist, rounds, qrounds, syncs = _closure(
            a.dist, a.adj, tables.btt, self.backend, 0, mask, a.now,
            _f32(tables.max_window, self.device))
        self._arrays = a._replace(dist=dist)
        self._account(rounds, qrounds, tables.n_live, syncs)

    def emit(self, tables: QueryTables) -> torch.Tensor:
        """(Q, N, N) bool device tensor of pairs valid over each query's
        window at the current stream clock."""
        a = self._arrays
        return batched_valid_pairs(a.dist, tables.finals_mask,
                                   a.now - tables.windows)

    def expire(self, tau: float, max_window: float) -> np.ndarray:
        self._arrays, live = _expire(self._arrays, _f32(tau, self.device),
                                     _f32(max_window, self.device))
        return device_get(live)

    def clear_slots(self, slots: Sequence[int]) -> None:
        idx = torch.as_tensor(list(slots), dtype=torch.int64).to(self.device)
        self._arrays = _clear_slots(self._arrays, idx)

    def clear_lane(self, lane: int) -> None:
        a = self._arrays
        a.dist[lane] = NEG_INF
        a.emitted[lane] = False

    def set_lane_emitted(self, lane: int, valid_lane: torch.Tensor) -> None:
        self._arrays.emitted[lane] = valid_lane

    def advance_clock(self, ts: float) -> None:
        a = self._arrays
        self._arrays = a._replace(now=torch.maximum(a.now, _f32(ts, self.device)))

    # -- round accounting ----------------------------------------------------

    def _account(self, rounds: int, qrounds: torch.Tensor, n_live: int,
                 syncs: int) -> None:
        self._rounds_total += rounds
        self._unmasked_query_rounds_total += n_live * rounds
        self.host_syncs += syncs
        self._pending_counts.append(qrounds)
        if len(self._pending_counts) >= 256:
            self._flush_counts()

    def _flush_counts(self) -> None:
        for qrounds in self._pending_counts:
            self._consume_count(qrounds)
        self._pending_counts.clear()

    def _consume_count(self, qrounds: torch.Tensor) -> None:
        self._query_rounds_total += int(device_get(qrounds.sum()))

    @property
    def rounds_total(self) -> int:
        """Global closure iterations (each dispatch's loop runs until its
        slowest participating query converges)."""
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
        return self._unmasked_query_rounds_total


class LocalExecutor(Executor):
    """Single-device executor (the only one ported; the mesh executor is
    ROADMAP A11)."""
