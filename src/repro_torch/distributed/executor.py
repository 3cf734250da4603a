"""MeshExecutor: the batched dense engine's device work over a grid of
devices — the counterpart of ``repro.distributed.executor`` — and the
mesh's one-round lowerings, the unit ``launch/dryrun_rpq.py`` prices.

One process drives every device (the reference is single-controller too).
The grid is ``(data, model)`` (:func:`~repro_torch.launch.mesh.
make_host_grid`), and the state lies as the reference lays it out
(``_adj_shardings``, ``_dist_shardings``):

    dist     (Q, N, N, K)  lanes in blocks of Q / data over the data axis,
                           v in blocks of N / model over the model axis
             row-sparse:   each lane shard's (Q_l, N, C) slot leaves on its
                           first device; the one overflow table on the
                           grid's first device
    emitted  (Q, N, N)     blocked as the dense dist
    adj      (L, N, N)     model peer m reads its u-row block adj[:, m, :]
                           (its contraction) and its v-column block
                           adj[:, :, m] (the base term): the reference's
                           ``adj_u`` / ``adj_v``. A device that hosts every
                           model peer keeps the whole slab once and the
                           peers' blocks are views of it (``["cuda:0"] * 4``
                           holds one slab, as a local executor does); any
                           other device keeps its peers' two blocks.
             ELL:          a replica of the (small, O(L*N*E)) leaves and
                           spill ring on each device of the grid, every
                           replica updated from the batch; each peer
                           densifies only its own two blocks from its
                           device's replica. The reference shards the rows
                           over the model axis instead; here a peer's v
                           block would then need every other peer's rows
                           each dispatch, which a replica never moves.
    now      ()            on the first device

A batch crosses the devices (B edges to each), the adjacency never does,
and no ingest or delete dispatch builds an (L, N, N) adjacency or a
(Q, N, N, K) dist on one device: a row-sparse dist densifies per lane
shard, each peer takes its v columns (views on the shard's own device),
and the shard re-packs its own lanes afterwards, with the overflow table's
rows claimed in the whole slab's flattened row order
(:func:`~repro_torch.core.sparse_dist.rsd_pack_rows`), so every leaf is
the local executor's. Drains and re-packs of either sparse layout run
without a dense slab too (the ELL re-pack from the live entries, on each
replica; the dist's from its slots and table, gathered as (Q, N, C)
leaves).

Convergence-aware dispatch, the reason this layer exists: each lane shard
relaxes only its own lanes' transition rows
(:func:`~repro_torch.core.semiring.shards_closure`), so

  * a shard whose lanes are all converged or inert SKIPS the dispatch (a
    lane registered mid-stream relaxes one shard, the others do nothing);
  * an active shard stops at its OWN fixpoint instead of riding until the
    globally slowest lane converges.

The counters show it: ``shard_rounds_total`` (rounds the shards ran) beside
``n_shards * sync_rounds_total`` (every shard riding to the dispatch's
slowest); ``skipped_shard_rounds_total`` is their gap. The model peers of
a lane shard each contract their own u block and fold the partials with
max, so each runs one contraction a shard-round: kernel B1's launches are
``n_model * shard_rounds_total`` on the float backend, B3's on the bucket
backend. The mesh relaxes the canonical dense slabs, as the reference
does: kernels B5 and B6 (ELL adjacency, row-sparse dist) never run here.

Result streams are BIT-identical to :class:`~repro_torch.core.executor.
LocalExecutor`: max and min never reassociate, and each lane's fixpoint
depends only on its own slices and the adjacency. A logical gather of the
shards happens at snapshot, restore, growth and registration (``arrays``,
``dense_adj``, ``dense_dist``, ``place``, ``grow``, ``emit``), never in an
ingest or delete dispatch, whose emit and valid-pairs diff run per shard;
each dispatch returns its (Q, N, N) result matrix on the first device.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.contraction import BackendLike, resolve_backend
from ..core.executor import (
    BatchedEngineArrays,
    Executor,
    HostBatch,
    QueryTables,
    _f32,
)
from ..core.semiring import (
    NEG_INF,
    BatchedTransitionTable,
    FrontierStats,
    Shard,
    _Operands,
    _shard_frontier_round,
    _shard_round,
    _shard_rows_np,
    _tables_from_rows,
    batched_valid_pairs,
    peer_views,
    shards_closure,
    shards_frontier,
)
from ..core.sparse_adj import (
    EllAdjacency,
    ell_block_to_dense,
    ell_clear_slots,
    ell_delete,
    ell_expire,
    ell_incident,
    ell_insert,
    ell_to_dense,
)
from ..core.sparse_dist import (
    RowSparseDist,
    rsd_clear_lane,
    rsd_clear_slots,
    rsd_pack_rows,
    rsd_rows_to_dense,
    rsd_to_dense,
    rsd_valid_pairs,
)
from ..device import DeviceLike, device_get
from ..launch.mesh import make_host_grid

#: the reference's name for the host grid (``host_mesh``), kept for callers
host_devices = make_host_grid


class ShardGrid(NamedTuple):
    """A logical ``(Q, N, N[, K])`` tensor as blocks: ``blocks[i][m]`` holds
    lane shard i's lanes and model peer m's v columns, on that grid cell's
    device."""

    blocks: List[List[torch.Tensor]]
    shape: Tuple[int, ...]

    def numel(self) -> int:
        return int(np.prod(self.shape))


class AdjGrid(NamedTuple):
    """The dense ``(L, N, N)`` adjacency at rest: ``pieces[dev]`` maps the
    ``(r0, r1, c0, c1)`` block of the logical slab to the tensor device
    ``dev`` keeps for it — the whole slab, or its peers' u-row and
    v-column blocks (see the module docstring)."""

    pieces: Dict[torch.device, Dict[Tuple[int, int, int, int], torch.Tensor]]
    shape: Tuple[int, int, int]

    def numel(self) -> int:
        return int(np.prod(self.shape))


class RsdShards(NamedTuple):
    """A row-sparse dist at rest: lane shard i's slot leaves ``idx[i]`` /
    ``ts[i]`` (Q_l, N, C) on its first device, and the overflow table
    ``(ovf_rows, ovf_ts, ovf_ptr, lost)`` once, on the grid's first
    device. ``shape`` is the logical dense shape."""

    idx: List[torch.Tensor]
    ts: List[torch.Tensor]
    table: Tuple[torch.Tensor, ...]
    shape: Tuple[int, int, int, int]

    def numel(self) -> int:
        return int(np.prod(self.shape))


def _result_grid(results, shape) -> ShardGrid:
    """The per-shard result blocks of a dispatch as a grid."""
    return ShardGrid([list(r[0]) for r in results], shape)


def _whole(n: int) -> Tuple[int, int, int, int]:
    return (0, n, 0, n)


class MeshExecutor(Executor):
    """Sharded executor: lanes over the grid's data axis, the dist's v
    axis over its model axis, the adjacency as each peer's u and v blocks,
    convergence-aware per-shard dispatch (see the module docstring).
    ``devices=None`` means every visible CUDA card and raises without one;
    pass a list (repeats allowed) for anything else. ``q_multiple`` /
    ``n_multiple`` make the engine round its lane and vertex capacities to
    the grid. State goes in and out as logical tensors, so a mesh snapshot
    restores onto a local executor and the reverse."""

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None,
                 model_axis: int = 1, backend=None, frontier: str = "off",
                 frontier_cap: int = 32, adj_layout: str = "dense",
                 ell_cap: int = 8, spill_cap: int = 256,
                 dist_layout: str = "dense", dist_cap: int = 16,
                 dist_ovf_cap: Optional[int] = None):
        self.grid = make_host_grid(model_axis, devices)
        super().__init__(backend, frontier=frontier, frontier_cap=frontier_cap,
                         adj_layout=adj_layout, ell_cap=ell_cap,
                         spill_cap=spill_cap, dist_layout=dist_layout,
                         dist_cap=dist_cap, dist_ovf_cap=dist_ovf_cap,
                         device=self.grid[0][0])
        self.n_shards = len(self.grid)
        self.n_model = len(self.grid[0])
        self.q_multiple = self.n_shards
        self.n_multiple = self.n_model
        #: the model peers each distinct device hosts, in grid order
        self._peers_of: Dict[torch.device, List[int]] = {}
        for row in self.grid:
            for m, dev in enumerate(row):
                peers = self._peers_of.setdefault(dev, [])
                if m not in peers:
                    peers.append(m)
        #: the ELL adjacency's replica on each device (the first device's
        #: is also ``_arrays.adj``)
        self._ell_reps: Dict[torch.device, EllAdjacency] = {}
        # per-shard tables (one per peer, on its device) and the host live
        # mask, rebuilt when the engine's transition table object changes
        self._rows_src = None
        self._tables: List[List] = []
        self._live_host: Optional[np.ndarray] = None
        self._shard_rounds_total = 0
        self._sync_rounds_total = 0
        self._skipped_shard_rounds_total = 0

    # -- layout ---------------------------------------------------------------

    def _lanes(self, i: int, q: Optional[int] = None) -> slice:
        """Lane shard i's lanes (of ``q`` lanes; default the state's)."""
        q_l = (self.dist_shape[0] if q is None else q) // self.n_shards
        return slice(i * q_l, (i + 1) * q_l)

    def _block_of(self, lane: int) -> Tuple[int, int]:
        """(lane shard, row in its blocks) of a lane."""
        return divmod(lane, self.dist_shape[0] // self.n_shards)

    def _cols(self, m: int) -> slice:
        n_m = self.dist_shape[1] // self.n_model
        return slice(m * n_m, (m + 1) * n_m)

    def _split(self, x: torch.Tensor) -> ShardGrid:
        """Logical tensor -> blocks (each its own contiguous copy)."""
        q_l = x.shape[0] // self.n_shards
        n_m = x.shape[2] // self.n_model
        return ShardGrid(
            [[x[i * q_l:(i + 1) * q_l, :, m * n_m:(m + 1) * n_m]
              .to(dev).contiguous() for m, dev in enumerate(row)]
             for i, row in enumerate(self.grid)], tuple(x.shape))

    def _join(self, blocks: List[List[torch.Tensor]]) -> torch.Tensor:
        """Blocks -> one logical tensor on the first device (the block
        itself on a 1x1 grid)."""
        if len(blocks) == 1 and len(blocks[0]) == 1:
            return blocks[0][0].to(self.device)
        return torch.cat([torch.cat([b.to(self.device) for b in row], dim=2)
                          for row in blocks], dim=0)

    # -- the adjacency at rest ------------------------------------------------

    def _piece_keys(self, dev: torch.device, n: int):
        """The ``(r0, r1, c0, c1)`` blocks device ``dev`` keeps of an
        (L, N, N) slab: the whole slab where it hosts every model peer,
        else its peers' u-row and v-column blocks."""
        peers = self._peers_of[dev]
        if len(peers) == self.n_model:
            return [_whole(n)]
        n_m = n // self.n_model
        return [key for m in peers
                for key in ((m * n_m, (m + 1) * n_m, 0, n),
                            (0, n, m * n_m, (m + 1) * n_m))]

    def _split_adj(self, adj: torch.Tensor) -> AdjGrid:
        """Logical dense slab -> :class:`AdjGrid` (the slab itself where
        it already lies on a device that keeps it whole)."""
        n = adj.shape[1]
        pieces = {}
        for dev in self._peers_of:
            pieces[dev] = {}
            for key in self._piece_keys(dev, n):
                r0, r1, c0, c1 = key
                pieces[dev][key] = adj[:, r0:r1, c0:c1].to(dev).contiguous()
        return AdjGrid(pieces, tuple(adj.shape))

    def _peer_adj(self, dev: torch.device, m: int, cache: dict):
        """Model peer m's (u-row, v-column) adjacency blocks on ``dev``:
        views of the blocks at rest, or for ELL its own two blocks
        densified from the device's replica (once per dispatch: ``cache``)."""
        a = self._arrays.adj
        n = self.adj_shape[1]
        if isinstance(a, AdjGrid):
            held = a.pieces[dev]
            if _whole(n) in held:
                return peer_views(held[_whole(n)], m, self.n_model)
            n_m = n // self.n_model
            return (held[(m * n_m, (m + 1) * n_m, 0, n)],
                    held[(0, n, m * n_m, (m + 1) * n_m)])
        if (dev, m) not in cache:
            rep = self._ell_reps[dev]
            if self.n_model == 1:
                whole = ell_to_dense(rep)
                cache[(dev, m)] = (whole, whole)
            else:
                cols = self._cols(m)
                cache[(dev, m)] = (ell_block_to_dense(rep, cols, slice(0, n)),
                                   ell_block_to_dense(rep, slice(0, n), cols))
        return cache[(dev, m)]

    def _gather_adj(self) -> torch.Tensor:
        """The dense adjacency as one logical slab on the first device."""
        a = self._arrays.adj
        n = a.shape[1]
        if _whole(n) in a.pieces[self.device]:
            return a.pieces[self.device][_whole(n)]
        return torch.cat([self._peer_adj(dev, m, {})[0].to(self.device)
                          for m, dev in enumerate(self.grid[0])], dim=1)

    def _set_ell(self, reps: Dict[torch.device, EllAdjacency]) -> EllAdjacency:
        self._ell_reps = reps
        return reps[self.device]

    def _map_adj(self, dense_fn, ell_fn):
        """Apply an update to every block at rest (``dense_fn(dev, key,
        tensor)``, in place) or every ELL replica (``ell_fn(dev, rep) ->
        rep``); returns the new ``adj`` state."""
        a = self._arrays.adj
        if isinstance(a, EllAdjacency):
            return self._set_ell({dev: ell_fn(dev, rep)
                                  for dev, rep in self._ell_reps.items()})
        for dev, held in a.pieces.items():
            for key, t in held.items():
                dense_fn(dev, key, t)
        return a

    def _on_devices(self, *xs: torch.Tensor):
        """``xs`` (on the first device) on every device of the grid: the
        first device's own tensors, device-to-device copies elsewhere (a
        copy from host memory would wait for each device's queued work)."""
        return {dev: tuple(x.to(dev, non_blocking=True) for x in xs)
                for dev in self._peers_of}

    def _apply_adj(self, host: HostBatch, batch: Tuple[torch.Tensor, ...]):
        """Fold the masked batch into the adjacency (newest-timestamp max):
        each block takes the batch edges inside it, each replica the whole
        batch (``apply_batch`` per block). ``batch`` is ``(src, dst, lab,
        eff_ts)`` on the first device, ``eff_ts`` -inf for masked rows."""
        on = self._on_devices(*batch)
        n = self.adj_shape[1]

        def dense(dev, key, t):
            src, dst, lab, ts = on[dev]
            r0, r1, c0, c1 = key
            if key == _whole(n):        # every edge is inside: apply_batch's fold
                flat = (lab * n + src) * n + dst
            else:
                inside = (src >= r0) & (src < r1) & (dst >= c0) & (dst < c1)
                flat = torch.where(inside, (lab * (r1 - r0) + src - r0)
                                   * (c1 - c0) + dst - c0, 0)
                ts = torch.where(inside, ts, NEG_INF)
            t.view(-1).scatter_reduce_(0, flat, ts, "amax", include_self=True)

        return self._map_adj(dense, lambda dev, rep: ell_insert(
            rep, host.src, host.dst, host.lab, on[dev][3], host.mask))

    def _drop_adj(self, host: HostBatch, batch: Tuple[torch.Tensor, ...]):
        """Clear the masked batch's edges from every block or replica
        (``drop_batch`` per block). ``batch`` is ``(src, dst, lab, mask)``
        on the first device; a block takes a min with -inf at its edges
        and with +inf (nothing) elsewhere."""
        on = self._on_devices(*batch)

        def dense(dev, key, t):
            src, dst, lab, mask = on[dev]
            r0, r1, c0, c1 = key
            hit = mask & (src >= r0) & (src < r1) & (dst >= c0) & (dst < c1)
            flat = (lab * (r1 - r0) + src - r0) * (c1 - c0) + dst - c0
            t.view(-1).scatter_reduce_(
                0, torch.where(hit, flat, 0),
                torch.where(hit, NEG_INF, float("inf")).to(t.dtype), "amin",
                include_self=True)

        return self._map_adj(dense, lambda dev, rep: ell_delete(
            rep, host.src, host.dst, host.lab, host.mask))

    # -- the row-sparse dist at rest ------------------------------------------

    def _shard_rsd(self, sd: RowSparseDist) -> RsdShards:
        lanes = [self._lanes(i, sd.n_lanes) for i in range(self.n_shards)]
        return RsdShards(
            [sd.idx[s].to(row[0]) for s, row in zip(lanes, self.grid)],
            [sd.ts[s].to(row[0]) for s, row in zip(lanes, self.grid)],
            tuple(x.to(self.device) for x in sd[2:]),
            (sd.n_lanes, sd.n_slots, sd.n_slots, sd.k))

    def _gather_rsd(self, d: RsdShards) -> RowSparseDist:
        return RowSparseDist(torch.cat([x.to(self.device) for x in d.idx]),
                             torch.cat([x.to(self.device) for x in d.ts]),
                             *d.table)

    @contextmanager
    def _logical_rsd(self):
        """The logical row-sparse dist (gathered on the first device) as
        ``_arrays.dist`` inside the block, for the base class's
        maintenance paths; whatever it leaves there is sharded after."""
        self._arrays = self._arrays._replace(
            dist=self._gather_rsd(self._arrays.dist))
        try:
            yield self._arrays.dist
        finally:
            self._arrays = self._arrays._replace(
                dist=self._shard_rsd(self._arrays.dist))

    def _densify_rows(self, d: RsdShards, i: int, r0: int, r1: int,
                      dev: torch.device) -> torch.Tensor:
        """Lane shard i's dense rows [r0, r1) (local flattened ``q * N +
        x``), (r1 - r0, N*K) on ``dev``."""
        q_l, n, c = d.idx[i].shape
        ovf_rows, ovf_ts = (x.to(dev, non_blocking=True) for x in d.table[:2])
        return rsd_rows_to_dense(d.idx[i].view(q_l * n, c)[r0:r1].to(dev),
                                 d.ts[i].view(q_l * n, c)[r0:r1].to(dev),
                                 ovf_rows, ovf_ts, i * q_l * n + r0)

    # -- state ---------------------------------------------------------------

    @property
    def arrays(self) -> BatchedEngineArrays:
        """The state as logical tensors on the first device (a gather)."""
        a = self._arrays
        adj = a.adj if isinstance(a.adj, EllAdjacency) else self._gather_adj()
        dist = (self._gather_rsd(a.dist) if isinstance(a.dist, RsdShards)
                else self._join(a.dist.blocks))
        return BatchedEngineArrays(adj, dist, self.dense_emitted(), a.now)

    def set_arrays(self, arrays: BatchedEngineArrays) -> None:
        adj = arrays.adj
        if isinstance(adj, EllAdjacency):
            adj = self._set_ell({dev: EllAdjacency(*[x.to(dev) for x in adj])
                                 for dev in self._peers_of})
        else:
            adj = self._split_adj(adj)
        dist = arrays.dist
        dist = (self._shard_rsd(dist) if isinstance(dist, RowSparseDist)
                else self._split(dist))
        self._arrays = BatchedEngineArrays(
            adj, dist, self._split(arrays.emitted), arrays.now)

    def load_dist(self, sd: RowSparseDist, budget: int = 0) -> None:
        super().load_dist(sd, budget)
        self._arrays = self._arrays._replace(dist=self._shard_rsd(sd))

    def dense_adj(self) -> torch.Tensor:
        a = self._arrays.adj
        return ell_to_dense(a) if isinstance(a, EllAdjacency) else self._gather_adj()

    def dense_dist(self) -> torch.Tensor:
        d = self._arrays.dist
        if isinstance(d, RsdShards):
            return rsd_to_dense(self._gather_rsd(d))
        return self._join(d.blocks)

    def dense_emitted(self) -> torch.Tensor:
        return self._join(self._arrays.emitted.blocks)

    def lane_dist(self, lanes: Sequence[int]) -> torch.Tensor:
        d = self._arrays.dist
        n, k = self.dist_shape[1], self.dist_shape[3]
        if isinstance(d, RsdShards):
            return torch.stack([
                self._densify_rows(d, i, r * n, (r + 1) * n, self.device)
                .view(n, n, k) for i, r in map(self._block_of, lanes)])
        return torch.stack([
            torch.cat([b[r].to(self.device) for b in d.blocks[i]], dim=1)
            for i, r in map(self._block_of, lanes)])

    @property
    def dist_stats(self) -> Dict[str, object]:
        if not isinstance(self._arrays.dist, RsdShards):
            return super().dist_stats
        with self._logical_rsd():
            return super().dist_stats

    def _drain_dist(self) -> None:
        with self._logical_rsd():
            super()._drain_dist()

    def _repack_ell(self) -> None:
        """Re-pack every replica on its own device (the first one first:
        it sets the grown ``ell_cap`` the others then need no more of)."""
        reps = {self.device: self._repack(self._ell_reps[self.device])}
        reps.update({dev: self._repack(rep) for dev, rep in self._ell_reps.items()
                     if dev != self.device})
        self._arrays = self._arrays._replace(adj=self._set_ell(reps))
        self._ell_repacks += 1

    def expire(self, tau: float, max_window: float) -> np.ndarray:
        """Window expiry on every block or replica; the per-slot liveness
        from peer m's blocks on the first lane shard's row (its u block's
        out-edges, its v block's in-edges)."""
        a = self._arrays
        now = torch.maximum(a.now, _f32(tau, self.device))
        low = now - _f32(max_window, self.device)
        lows = {dev: low.to(dev) for dev in self._peers_of}
        adj = self._map_adj(
            lambda dev, key, t: t.masked_fill_(~(t > lows[dev]), NEG_INF),
            lambda dev, rep: ell_expire(rep, lows[dev]))
        self._arrays = a._replace(adj=adj, now=now)
        if isinstance(adj, EllAdjacency):
            incident = ell_incident(adj)
        else:
            views = [self._peer_adj(dev, m, {}) for m, dev in enumerate(self.grid[0])]
            incident = torch.maximum(
                torch.cat([u.amax(dim=(0, 2)).to(self.device) for u, _ in views]),
                torch.cat([v.amax(dim=(0, 1)).to(self.device) for _, v in views]))
        return device_get(incident > low)

    def clear_slots(self, slots: Sequence[int]) -> None:
        """Rows and columns of the recycled slots to -inf (False), in every
        block, replica and lane shard: each block masks the dead slots of
        its own row and column range."""
        a = self._arrays
        idx = torch.as_tensor(list(slots), dtype=torch.int64).to(self.device)
        dead = torch.zeros((self.dist_shape[1],), dtype=torch.bool,
                           device=self.device).index_fill_(0, idx, True)
        dead_on = {dev: d for dev, (d,) in self._on_devices(dead).items()}

        def dense(dev, key, t):
            r0, r1, c0, c1 = key
            t.masked_fill_(dead_on[dev][r0:r1][None, :, None], NEG_INF)
            t.masked_fill_(dead_on[dev][c0:c1][None, None, :], NEG_INF)

        self._arrays = a._replace(adj=self._map_adj(
            dense, lambda dev, rep: ell_clear_slots(rep, dead_on[dev])))
        if isinstance(a.dist, RsdShards):
            with self._logical_rsd() as sd:
                rsd_clear_slots(sd, dead)
            grids = [(a.emitted, False)]
        else:
            grids = [(a.dist, NEG_INF), (a.emitted, False)]
        for g, fill in grids:
            for row in g.blocks:
                for m, b in enumerate(row):
                    d = dead_on[b.device]
                    tail = (None,) * (b.dim() - 3)    # the dist's K axis
                    b.masked_fill_(d[(None, slice(None), None, *tail)], fill)
                    b.masked_fill_(d[self._cols(m)][(None, None, slice(None), *tail)],
                                   fill)

    def clear_lane(self, lane: int) -> None:
        a = self._arrays
        i, r = self._block_of(lane)
        if isinstance(a.dist, RsdShards):
            with self._logical_rsd() as sd:
                rsd_clear_lane(sd, lane)
        else:
            for b in a.dist.blocks[i]:
                b[r] = NEG_INF
        for b in a.emitted.blocks[i]:
            b[r] = False

    def set_lane_emitted(self, lane: int, valid_lane: torch.Tensor) -> None:
        i, r = self._block_of(lane)
        for m, b in enumerate(self._arrays.emitted.blocks[i]):
            b[r].copy_(valid_lane[:, self._cols(m)])

    def emit(self, tables: QueryTables) -> torch.Tensor:
        d = self._arrays.dist
        low = self.now - tables.windows
        if isinstance(d, RsdShards):
            return rsd_valid_pairs(self._gather_rsd(d), tables.finals_mask, low)
        return self._join(self._valid(d, tables, low))

    # -- dispatches ----------------------------------------------------------

    def _lane_tables(self, tables: QueryTables) -> List[List]:
        """Per-shard, per-peer transition tables and the host live mask,
        cached on the table object (lifecycle events replace it)."""
        if self._rows_src is not tables.btt:
            self._tables = _grid_tables(tables.btt, self.dist_shape[0], self.grid)
            self._live_host = tables.live_host
            self._rows_src = tables.btt
        return self._tables

    def _dist_blocks(self):
        """The dispatch's dense dist as blocks, and for a row-sparse dist
        the per-shard (Q_l, N, N, K) slabs it was densified into (each on
        its shard's first device; the blocks of peers on that device are
        views of it), None for the dense layout."""
        d = self._arrays.dist
        if not isinstance(d, RsdShards):
            return d, None
        q, n, _, k = d.shape
        q_l = q // self.n_shards
        slabs, blocks = [], []
        for i, row in enumerate(self.grid):
            slab = self._densify_rows(d, i, 0, q_l * n, row[0]).view(q_l, n, n, k)
            slabs.append(slab)
            blocks.append([slab[:, :, self._cols(m)].to(dev, non_blocking=True)
                           for m, dev in enumerate(row)])
        return ShardGrid(blocks, d.shape), slabs

    def _shards(self, grid: ShardGrid, tables: QueryTables,
                query_mask: Optional[np.ndarray] = None) -> List[Shard]:
        """The dispatch's shards over ``grid``: the live lanes, or the lanes
        of ``query_mask``, with their host mirror, and each peer's u and v
        adjacency blocks."""
        lane_tables = self._lane_tables(tables)
        if query_mask is None:
            mask, mask_host = tables.live_mask, self._live_host
        else:
            mask_host = np.asarray(query_mask, bool)
            mask = torch.as_tensor(mask_host).to(self.device, non_blocking=True)
        cache: dict = {}
        out = []
        for i, row in enumerate(self.grid):
            lanes = self._lanes(i)
            views = [self._peer_adj(dev, m, cache) for m, dev in enumerate(row)]
            out.append(Shard(grid.blocks[i], [u for u, _ in views],
                             [v for _, v in views], lane_tables[i],
                             mask[lanes].to(row[0]), mask_host[lanes]))
        return out

    def _store(self, grid: ShardGrid, slabs) -> Tuple[object, int]:
        """The dispatch's result grid as the new dist: the grid itself, or
        each shard's slab (its blocks that are not views of it written
        back first) re-packed into its slot leaves, the overflow table
        claimed in the whole slab's row order. Returns ``(dist,
        host_reads)``."""
        if slabs is None:
            return grid, 0
        for i, (row, slab) in enumerate(zip(grid.blocks, slabs)):
            for m, b in enumerate(row):
                view = slab[:, :, self._cols(m)]
                if b.device != view.device or b.data_ptr() != view.data_ptr():
                    view.copy_(b)
        d = self._arrays.dist
        q, n, _, k = d.shape
        idx, ts, table, reads = rsd_pack_rows(
            [s.view(s.shape[0], n, n * k) for s in slabs], d.idx[0].shape[2],
            d.table[0].shape[0], d.table[3], self.device)
        return RsdShards(idx, ts, table, d.shape), reads

    def _valid(self, grid: ShardGrid, tables: QueryTables, low: torch.Tensor):
        """Per-block window-valid pairs, ``(Q_l, N, N_m)`` each."""
        out = []
        for i, row in enumerate(grid.blocks):
            lanes = self._lanes(i)
            out.append([batched_valid_pairs(
                b, tables.finals_mask[lanes].to(b.device),
                low[lanes].to(b.device)) for b in row])
        return out

    def _closures(self, shards: List[Shard], tables: QueryTables, src, mask_t,
                  now, delete: bool):
        w_max = _f32(tables.max_window, self.device)
        if self.frontier != "off":
            res, syncs = shards_frontier(shards, src, mask_t, self.frontier_cap,
                                         self.backend, 0, now, w_max, delete)
            fstats = FrontierStats(
                sum(r[3].seed_rows for r in res),
                max(r[3].max_lane_rows for r in res),
                sum(r[3].rows_relaxed for r in res),
                sum(int(r[3].fell_back) for r in res))  # repro: noqa[R1] FrontierStats fields are host values
        else:
            if delete:  # from scratch, in place
                for sh in shards:
                    for b in sh.blocks:
                        b.fill_(NEG_INF)
            res, syncs = shards_closure(shards, self.backend, 0, now, w_max)
            fstats = None
        return res, syncs, fstats

    def _account_shards(self, res, tables: QueryTables, syncs: int, fstats,
                        is_delete: bool = False) -> None:
        shard_rounds = np.array([r[1] for r in res], np.int64)
        qrounds = torch.cat([r[2].to(self.device) for r in res])
        self._account(shard_rounds, qrounds, tables, syncs, fstats, is_delete)

    def _host_batch(self, src, dst, lab, mask) -> HostBatch:
        return HostBatch(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                         np.asarray(lab, np.int64), np.asarray(mask, bool))

    def ingest_batch(self, src, dst, lab, ts, mask, ts_floor: float,
                     tables: QueryTables) -> torch.Tensor:
        """One ingest dispatch: fold the batch into every adjacency block,
        run every shard's closure (dense, or frontier with per-shard
        fallback), emit per shard. Returns the (Q, N, N) new-validity
        matrix on the first device."""
        if self.adj_layout == "ell":
            self._reserve_spill(len(src))
        if self.dist_layout == "row_sparse":
            self._reserve_dist(self.frontier != "off")
        host = self._host_batch(src, dst, lab, mask)
        src_t, dst_t, lab_t, ts_t, mask_t = self._batch(
            host.src, host.dst, host.lab, np.asarray(ts, np.float32), host.mask)
        eff_ts = torch.where(mask_t, ts_t, torch.full_like(ts_t, NEG_INF))
        now = torch.maximum(self.now, torch.maximum(
            eff_ts.max(), _f32(ts_floor, self.device)))
        adj = self._apply_adj(host, (src_t, dst_t, lab_t, eff_ts))
        self._arrays = self._arrays._replace(adj=adj)
        grid, slabs = self._dist_blocks()
        res, syncs, fstats = self._closures(self._shards(grid, tables),
                                            tables, src_t, mask_t, now, delete=False)
        grid = _result_grid(res, grid.shape)
        valid = self._valid(grid, tables, now - tables.windows)
        new = []
        for v_row, e_row in zip(valid, self._arrays.emitted.blocks):
            new.append([v & ~e for v, e in zip(v_row, e_row)])
            for v, e in zip(v_row, e_row):
                e.logical_or_(v)
        dist, reads = self._store(grid, slabs)
        self._arrays = BatchedEngineArrays(adj, dist, self._arrays.emitted, now)
        self._account_shards(res, tables, syncs + reads, fstats)
        self.steps += 1
        return self._join(new)

    def delete_batch(self, src, dst, lab, mask, ts_now: float,
                     tables: QueryTables) -> torch.Tensor:
        """Explicit deletion dispatch: every shard re-derives from scratch
        (or, with a frontier, its cone). Returns the (Q, N, N) invalidated
        pairs on the first device."""
        if self.dist_layout == "row_sparse":
            self._reserve_dist(self.frontier != "off")
        host = self._host_batch(src, dst, lab, mask)
        src_t, dst_t, lab_t, mask_t = self._batch(host.src, host.dst, host.lab,
                                                  host.mask)
        now = torch.maximum(self.now, _f32(ts_now, self.device))
        low = now - tables.windows
        grid, slabs = self._dist_blocks()
        before = self._valid(grid, tables, low)
        adj = self._drop_adj(host, (src_t, dst_t, lab_t, mask_t))
        self._arrays = self._arrays._replace(adj=adj)
        res, syncs, fstats = self._closures(self._shards(grid, tables),
                                            tables, src_t, mask_t, now, delete=True)
        grid = _result_grid(res, grid.shape)
        after = self._valid(grid, tables, low)
        invalidated = [[b & ~a for b, a in zip(b_row, a_row)]
                       for b_row, a_row in zip(before, after)]
        dist, reads = self._store(grid, slabs)
        self._arrays = BatchedEngineArrays(adj, dist, self._arrays.emitted, now)
        self._account_shards(res, tables, syncs + reads, fstats, is_delete=True)
        self.steps += 1
        return self._join(invalidated)

    def relax(self, tables: QueryTables,
              query_mask: Optional[np.ndarray] = None) -> None:
        """Every shard's closure to fixpoint in place (lane seeding at
        registration): only shards holding a lane of the mask run."""
        if self.dist_layout == "row_sparse":
            self._reserve_dist(False)
        grid, slabs = self._dist_blocks()
        res, syncs = shards_closure(self._shards(grid, tables, query_mask),
                                    self.backend, 0, self.now,
                                    _f32(tables.max_window, self.device))
        dist, reads = self._store(_result_grid(res, grid.shape), slabs)
        self._arrays = self._arrays._replace(dist=dist)
        self._account_shards(res, tables, syncs + reads, None)

    # -- accounting ----------------------------------------------------------

    def _count_ell(self, rounds, tables, fstats, n) -> None:
        """No ELL contraction runs here: the shards relax dense slabs."""

    def _consume_count(self, shard_rounds, qrounds, n_live: int) -> None:
        sr = np.asarray(shard_rounds)
        sync = int(sr.max()) if sr.size else 0
        self._rounds_total += sync
        self._sync_rounds_total += sync
        self._shard_rounds_total += int(sr.sum())
        self._skipped_shard_rounds_total += int((sync - sr).sum())
        self._query_rounds_total += int(device_get(qrounds.sum()))
        self._unmasked_query_rounds_total += n_live * sync

    def _consume_frontier(self, fstats, rounds, n_live: int, n: int,
                          is_delete: bool = False) -> None:
        # the dense-row equivalent rides the dispatch's slowest shard
        super()._consume_frontier(fstats, int(np.asarray(rounds).max()),
                                  n_live, n, is_delete)

    @property
    def shard_rounds_total(self) -> int:
        """Rounds the shards actually ran (skip-aware), summed over shards
        and dispatches."""
        self._flush_counts()
        return self._shard_rounds_total

    @property
    def sync_rounds_total(self) -> int:
        """Per-dispatch max over shards, summed: the rounds every shard
        would ride if none could stop early."""
        self._flush_counts()
        return self._sync_rounds_total

    @property
    def skipped_shard_rounds_total(self) -> int:
        """Shard-rounds the convergence-aware dispatch skipped:
        ``n_shards * sync_rounds_total - shard_rounds_total``."""
        self._flush_counts()
        return self._skipped_shard_rounds_total


def _grid_tables(btt: BatchedTransitionTable, q_cap: int,
                 grid: List[List[torch.device]]) -> List[List]:
    """Per lane shard, per model peer, the shard's transition table on the
    peer's device (built once per distinct device)."""
    rows = _shard_rows_np(btt, q_cap, len(grid))
    q_l = q_cap // len(grid)
    per_dev: dict = {}
    for row in grid:
        for dev in row:
            if dev not in per_dev:
                per_dev[dev] = _tables_from_rows(rows, btt.k, btt.n_labels,
                                                 q_l, dev)
    return [[per_dev[dev][i] for dev in row] for i, row in enumerate(grid)]


# ---------------------------------------------------------------------------
# One-round lowerings (reference :257-411): the mesh executor's round with
# no fixpoint loop, the unit launch/dryrun_rpq.py prices (a closure's round
# count depends on the data, so its cost is stated per round). They run the
# executor's shard functions, skip rule and backend.
# ---------------------------------------------------------------------------


def make_sharded_round(backend: BackendLike = None, n_model: int = 0):
    """One convergence-masked round over a dispatch's shards (reference
    ``make_sharded_round``): ``round_fn(shards, now=None, w_max=None)``
    returns each shard's new peer blocks, float32. The backend's
    representation boundary wraps the round: an active shard encodes its
    blocks (copies: the inputs are left as they were) and adjacency,
    contracts, folds, updates and decodes; a shard with no lane in its mask
    skips all of it and passes its blocks through. ``n_model`` larger than
    a shard's blocks runs only their peers' shares (``_shard_round``)."""
    backend = resolve_backend(backend)

    def round_fn(shards: Sequence[Shard], now=None, w_max=None):
        operands = _Operands(backend, now, w_max)
        out = []
        for sh in shards:
            if not sh.mask_host.any():
                out.append(list(sh.blocks))
                continue
            ops, (adj_u, adj_v) = operands.encode(sh)
            ops = [o.clone() if o is b else o for o, b in zip(ops, sh.blocks)]
            _shard_round(ops, adj_u, adj_v, sh.tables, backend, sh.mask,
                         n_model)
            out.append(operands.decode(ops))
        return out

    return round_fn


def make_sharded_frontier_round(backend: BackendLike = None,
                                n_model: int = 0):
    """One frontier-restricted round over a dispatch's shards (reference
    ``make_sharded_frontier_round``): ``round_fn(shards, frows, rowmasks,
    now=None, w_max=None)`` with each shard's (Q_l, F) frontier rows and
    its slot mask in host memory; a shard whose row mask is empty skips
    (read on the host, as the executor's skip reads its mirror). Returns
    each shard's new peer blocks, float32. ``n_model`` as in
    :func:`make_sharded_round`."""
    backend = resolve_backend(backend)

    def round_fn(shards: Sequence[Shard], frows, rowmasks, now=None,
                 w_max=None):
        operands = _Operands(backend, now, w_max)
        out = []
        for sh, rows, rm in zip(shards, frows, rowmasks):
            if not bool(rm.any()):  # repro: noqa[R1] the row masks lie in host memory (the skip reads them there)
                out.append(list(sh.blocks))
                continue
            ops, (adj_u, adj_v) = operands.encode(sh)
            ops = [o.clone() if o is b else o for o, b in zip(ops, sh.blocks)]
            _shard_frontier_round(ops, adj_u, adj_v, sh.tables, backend,
                                  rows, rm.to(ops[0].device, non_blocking=True),
                                  n_model)
            out.append(operands.decode(ops))
        return out

    return round_fn


class RoundLowering(NamedTuple):
    """A one-round lowering over a device grid: ``round_fn`` takes and
    returns logical tensors on the grid's first device; ``share_fn`` runs
    device (0, 0)'s share of the same round on that device's operands
    alone, the other model peers' partials stood in by its own in the fold
    (the dry run's unit; on a dist whose other peers' columns hold no
    finite entry it returns ``round_fn``'s block (0, 0)); ``block_shapes``
    are one device's operands (``dist`` (Q_l, N, N_m, K), ``adj_u`` (L, N_m,
    N), ``adj_v`` (L, N, N_m), and ``mask`` (Q_l,) or ``frows`` /
    ``rowmask`` (Q_l, F)); ``tables[i][m]`` is lane shard i's transition
    table on peer m's device."""

    round_fn: object
    share_fn: object
    block_shapes: Dict[str, Tuple[int, ...]]
    tables: List[List[BatchedTransitionTable]]


def _lowering_layout(grid, btt, q_cap: int, n_slots: int):
    n_shards, n_model = len(grid), len(grid[0])
    if q_cap % n_shards:
        raise ValueError(f"q_cap {q_cap} not divisible by {n_shards} lane shards")
    if n_slots % n_model:
        raise ValueError(f"n_slots {n_slots} not divisible by {n_model} model peers")
    q_l, n_m = q_cap // n_shards, n_slots // n_model
    shapes = {"dist": (q_l, n_slots, n_m, btt.k),
              "adj_u": (btt.n_labels, n_m, n_slots),
              "adj_v": (btt.n_labels, n_slots, n_m)}
    return q_l, n_m, shapes, _grid_tables(btt, q_cap, grid)


def _grid_shards(grid, tables, dist, adj, mask, q_l: int, n_m: int):
    """Logical dist (Q, N, N, K), adjacency (L, N, N) and (Q,) mask as the
    grid's shards: each peer's dist block, u and v adjacency blocks on its
    device."""
    out = []
    for i, row in enumerate(grid):
        lanes = slice(i * q_l, (i + 1) * q_l)
        blocks = [dist[lanes, :, m * n_m:(m + 1) * n_m].to(dev).contiguous()
                  for m, dev in enumerate(row)]
        views = [peer_views(adj.to(dev), m, len(row)) for m, dev in enumerate(row)]
        m_i = mask[lanes]
        out.append(Shard(blocks, [u for u, _ in views], [v for _, v in views],
                         tables[i], m_i.to(row[0]), device_get(m_i)))  # repro: noqa[R1] the shard mask's host mirror, one read a call of the dry run's logical-tensor entry
    return out


def _join_blocks(blocks, home: torch.device) -> torch.Tensor:
    return torch.cat([torch.cat([b.to(home) for b in row], dim=2)
                      for row in blocks], dim=0)


def batched_round_lowering(grid: List[List[torch.device]],
                           btt: BatchedTransitionTable, q_cap: int,
                           n_slots: int, backend: BackendLike = None
                           ) -> RoundLowering:
    """The mesh executor's dense round as a lowering (reference
    ``batched_round_lowering``): ``round_fn(dist, adj, query_mask, now=None,
    w_max=None)`` with dist (q_cap, N, N, K) lanes over the grid's data
    axis and v over its model axis, the (Q,) convergence mask, and the
    stream-clock scalars a clock-anchored backend (the bucket backend)
    quantizes against. ``q_cap`` is a multiple of the lane shards (inert
    lanes are the engine's padding)."""
    q_l, n_m, shapes, tables = _lowering_layout(grid, btt, q_cap, n_slots)
    shapes["mask"] = (q_l,)
    sharded = make_sharded_round(backend)
    share = make_sharded_round(backend, len(grid[0]))

    def round_fn(dist, adj, query_mask, now=None, w_max=None):
        shards = _grid_shards(grid, tables, dist, adj,
                              torch.as_tensor(query_mask), q_l, n_m)
        return _join_blocks(sharded(shards, now, w_max), dist.device)

    def share_fn(blk, adj_u, adj_v, mask, now=None, w_max=None):
        """``mask``: device (0, 0)'s (Q_l,) lanes, in host memory."""
        mask = torch.as_tensor(mask)
        sh = Shard([blk], [adj_u], [adj_v], [tables[0][0]],
                   mask.to(blk.device, non_blocking=True), mask.numpy())  # repro: noqa[R1] mask lies in host memory (share_fn's contract): .numpy() copies nothing
        return share([sh], now, w_max)[0][0]

    return RoundLowering(round_fn, share_fn, shapes, tables)


def frontier_round_lowering(grid: List[List[torch.device]],
                            btt: BatchedTransitionTable, q_cap: int,
                            n_slots: int, f_cap: int,
                            backend: BackendLike = None) -> RoundLowering:
    """The frontier round as a lowering (reference
    ``frontier_round_lowering``): like :func:`batched_round_lowering`, the
    contraction restricted to a (q_cap, f_cap) frontier — ``round_fn(dist,
    adj, frows, rowmask, now=None, w_max=None)`` — so a device contracts
    (J_l, F, N_m) slabs, O(J*F*N^2) over the grid."""
    q_l, n_m, shapes, tables = _lowering_layout(grid, btt, q_cap, n_slots)
    shapes["frows"] = shapes["rowmask"] = (q_l, f_cap)
    sharded = make_sharded_frontier_round(backend)
    share = make_sharded_frontier_round(backend, len(grid[0]))

    def round_fn(dist, adj, frows, rowmask, now=None, w_max=None):
        live = torch.ones((dist.shape[0],), dtype=torch.bool)
        shards = _grid_shards(grid, tables, dist, adj, live, q_l, n_m)
        frows_i = [frows[i * q_l:(i + 1) * q_l].to(row[0], torch.int64)
                   for i, row in enumerate(grid)]
        rm_i = [rowmask[i * q_l:(i + 1) * q_l].cpu() for i in range(len(grid))]  # repro: noqa[R1] the skip reads the row masks on the host, as the executor's reads its mirror
        return _join_blocks(sharded(shards, frows_i, rm_i, now, w_max),
                            dist.device)

    def share_fn(blk, adj_u, adj_v, frows, rowmask, now=None, w_max=None):
        """``frows`` on the block's device, ``rowmask`` in host memory."""
        sh = Shard([blk], [adj_u], [adj_v], [tables[0][0]],
                   torch.ones((q_l,), dtype=torch.bool, device=blk.device),
                   np.ones((q_l,), dtype=bool))
        return share([sh], [frows], [torch.as_tensor(rowmask)], now,
                     w_max)[0][0]

    return RoundLowering(round_fn, share_fn, shapes, tables)
