"""MeshExecutor: the batched dense engine's device work over a grid of
devices — the counterpart of ``repro.distributed.executor``.

One process drives every device (the reference is single-controller too).
The grid is ``(data, model)`` (:func:`host_devices`), and the state lies:

    dist     (Q, N, N, K)  lanes in blocks of Q / data over the data axis,
                           v in blocks of N / model over the model axis;
                           a row-sparse dist stays whole on the first
                           device and densifies per dispatch
    emitted  (Q, N, N)     blocked as dist
    adj      (L, N, N)     whole on the first device (dense or ELL); a
                           dispatch densifies an ELL one and copies it once
                           to each other device of the grid
    now      ()            on the first device

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
``dense_dist``, ``place``, ``grow``, ``emit``), never in an ingest or
delete dispatch, whose emit and valid-pairs diff run per shard; each
dispatch returns its (Q, N, N) result matrix on the first device.

A device list with repeats (``["cuda:0"] * 4``, ``["cpu"] * 8``) gives real
shards over one physical device, the counterpart of the reference's
``--xla_force_host_platform_device_count``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.executor import (
    BatchedEngineArrays,
    Executor,
    HostBatch,
    QueryTables,
    _f32,
    apply_batch,
    drop_batch,
)
from ..core.semiring import (
    NEG_INF,
    FrontierStats,
    Shard,
    _shard_rows_np,
    _tables_from_rows,
    batched_valid_pairs,
    shards_closure,
    shards_frontier,
)
from ..core.sparse_adj import EllAdjacency, ell_clear_slots, ell_to_dense
from ..core.sparse_dist import (
    RowSparseDist,
    _from_dense,
    rsd_clear_lane,
    rsd_clear_slots,
    rsd_to_dense,
)
from ..device import DeviceLike, device_get, resolve_device


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def host_devices(model_axis: int = 1,
                 devices: Optional[Sequence[DeviceLike]] = None
                 ) -> List[List[torch.device]]:
    """The ``(data, model)`` device grid (reference ``make_host_mesh``):
    ``devices`` (None: every visible CUDA card; raises without one), the
    model axis clamped to the device count, ``data = len(devices) //
    model``, row-major. A one-device list gives the 1x1 grid."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_canonical(resolve_device(d)) for d in devices]
    if not devs:
        raise ValueError("the mesh needs at least one device")
    model = max(1, min(int(model_axis), len(devs)))
    data = max(len(devs) // model, 1)
    return [devs[i * model:(i + 1) * model] for i in range(data)]


class ShardGrid(NamedTuple):
    """A logical ``(Q, N, N[, K])`` tensor as blocks: ``blocks[i][m]`` holds
    lane shard i's lanes and model peer m's v columns, on that grid cell's
    device."""

    blocks: List[List[torch.Tensor]]
    shape: Tuple[int, ...]

    def numel(self) -> int:
        return int(np.prod(self.shape))


def _result_grid(results, shape) -> ShardGrid:
    """The per-shard result blocks of a dispatch as a grid."""
    return ShardGrid([list(r[0]) for r in results], shape)


class MeshExecutor(Executor):
    """Sharded executor: lanes over the grid's data axis, the dist's v
    axis over its model axis, convergence-aware per-shard dispatch (see
    the module docstring). ``devices=None`` means every visible CUDA card
    and raises without one; pass a list (repeats allowed) for anything
    else. ``q_multiple`` / ``n_multiple`` make the engine round its lane
    and vertex capacities to the grid. State goes in and out as logical
    tensors, so a mesh snapshot restores onto a local executor and the
    reverse."""

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None,
                 model_axis: int = 1, backend=None, frontier: str = "off",
                 frontier_cap: int = 32, adj_layout: str = "dense",
                 ell_cap: int = 8, spill_cap: int = 256,
                 dist_layout: str = "dense", dist_cap: int = 16,
                 dist_ovf_cap: Optional[int] = None):
        self.grid = host_devices(model_axis, devices)
        super().__init__(backend, frontier=frontier, frontier_cap=frontier_cap,
                         adj_layout=adj_layout, ell_cap=ell_cap,
                         spill_cap=spill_cap, dist_layout=dist_layout,
                         dist_cap=dist_cap, dist_ovf_cap=dist_ovf_cap,
                         device=self.grid[0][0])
        self.n_shards = len(self.grid)
        self.n_model = len(self.grid[0])
        self.q_multiple = self.n_shards
        self.n_multiple = self.n_model
        # per-shard tables (one per peer, on its device) and the host live
        # mask, rebuilt when the engine's transition table object changes
        self._rows_src = None
        self._tables: List[List] = []
        self._live_host: Optional[np.ndarray] = None
        self._shard_rounds_total = 0
        self._sync_rounds_total = 0
        self._skipped_shard_rounds_total = 0

    # -- layout ---------------------------------------------------------------

    def _lanes(self, i: int) -> slice:
        q_l = self.dist_shape[0] // self.n_shards
        return slice(i * q_l, (i + 1) * q_l)

    def _block_of(self, lane: int) -> Tuple[int, int]:
        """(lane shard, row in its blocks) of a lane."""
        return divmod(lane, self.dist_shape[0] // self.n_shards)

    def _cols(self, m: int) -> slice:
        n_m = self.dist_shape[1] // self.n_model
        return slice(m * n_m, (m + 1) * n_m)

    def _split(self, x: torch.Tensor) -> ShardGrid:
        """Logical tensor -> blocks (views where a block is a contiguous
        lane range on the same device, copies otherwise)."""
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

    # -- state ---------------------------------------------------------------

    @property
    def arrays(self) -> BatchedEngineArrays:
        """The state as logical tensors on the first device (a gather)."""
        a = self._arrays
        dist = a.dist if isinstance(a.dist, RowSparseDist) else self._join(a.dist.blocks)
        return BatchedEngineArrays(a.adj, dist, self.dense_emitted(), a.now)

    def set_arrays(self, arrays: BatchedEngineArrays) -> None:
        dist = arrays.dist
        if not isinstance(dist, RowSparseDist):
            dist = self._split(dist)
        self._arrays = BatchedEngineArrays(
            arrays.adj, dist, self._split(arrays.emitted), arrays.now)

    def dense_dist(self) -> torch.Tensor:
        d = self._arrays.dist
        return rsd_to_dense(d) if isinstance(d, RowSparseDist) else self._join(d.blocks)

    def dense_emitted(self) -> torch.Tensor:
        return self._join(self._arrays.emitted.blocks)

    def lane_dist(self, lanes: Sequence[int]) -> torch.Tensor:
        d = self._arrays.dist
        if isinstance(d, RowSparseDist):
            return super().lane_dist(lanes)
        return torch.stack([
            torch.cat([b[r].to(self.device) for b in d.blocks[i]], dim=1)
            for i, r in map(self._block_of, lanes)])

    def clear_slots(self, slots: Sequence[int]) -> None:
        a = self._arrays
        idx = torch.as_tensor(list(slots), dtype=torch.int64).to(self.device)
        dead = torch.zeros((self.dist_shape[1],), dtype=torch.bool,
                           device=self.device).index_fill_(0, idx, True)
        if isinstance(a.adj, EllAdjacency):
            adj = ell_clear_slots(a.adj, dead)
        else:
            adj = a.adj.index_fill_(1, idx, NEG_INF).index_fill_(2, idx, NEG_INF)
        dist = a.dist
        if isinstance(dist, RowSparseDist):
            dist = rsd_clear_slots(dist, dead)
            grids = [(a.emitted, False)]
        else:
            grids = [(dist, NEG_INF), (a.emitted, False)]
        host = np.asarray(list(slots), np.int64)
        for g, fill in grids:
            for row in g.blocks:
                for m, b in enumerate(row):
                    cols = self._cols(m)
                    local = host[(host >= cols.start) & (host < cols.stop)] - cols.start
                    b.index_fill_(1, idx.to(b.device), fill)
                    if local.size:
                        b.index_fill_(2, torch.as_tensor(local).to(b.device), fill)
        self._arrays = BatchedEngineArrays(adj, dist, a.emitted, a.now)

    def clear_lane(self, lane: int) -> None:
        a = self._arrays
        i, r = self._block_of(lane)
        if isinstance(a.dist, RowSparseDist):
            rsd_clear_lane(a.dist, lane)
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
        if isinstance(d, RowSparseDist):
            return super().emit(tables)
        return self._join(self._valid(d, tables, self.now - tables.windows))

    # -- dispatches ----------------------------------------------------------

    def _lane_tables(self, tables: QueryTables) -> List[List]:
        """Per-shard, per-peer transition tables and the host live mask,
        cached on the table object (lifecycle events replace it)."""
        if self._rows_src is not tables.btt:
            rows = _shard_rows_np(tables.btt, self.dist_shape[0], self.n_shards)
            q_l = self.dist_shape[0] // self.n_shards
            per_dev = {}
            for row in self.grid:
                for dev in row:
                    if dev not in per_dev:
                        per_dev[dev] = _tables_from_rows(
                            rows, tables.btt.k, tables.btt.n_labels, q_l, dev)
            self._tables = [[per_dev[dev][i] for dev in row]
                            for i, row in enumerate(self.grid)]
            self._live_host = tables.live_host
            self._rows_src = tables.btt
        return self._tables

    def _dist_blocks(self):
        """The dispatch's dense dist as blocks, and the logical dense slab
        a row-sparse dist was densified into (None for the dense layout)."""
        d = self._arrays.dist
        if isinstance(d, RowSparseDist):
            dense = rsd_to_dense(d)
            return self._split(dense), dense
        return d, None

    def _shards(self, grid: ShardGrid, adj, tables: QueryTables,
                query_mask: Optional[np.ndarray] = None) -> List[Shard]:
        """The dispatch's shards over ``grid``: the live lanes, or the lanes
        of ``query_mask``, with their host mirror."""
        lane_tables = self._lane_tables(tables)
        if query_mask is None:
            mask, mask_host = tables.live_mask, self._live_host
        else:
            mask_host = np.asarray(query_mask, bool)
            mask = torch.as_tensor(mask_host).to(self.device)
        adj_d = ell_to_dense(adj) if isinstance(adj, EllAdjacency) else adj
        copies = {self.device: adj_d}
        for row in self.grid:
            for dev in row:
                if dev not in copies:
                    copies[dev] = adj_d.to(dev)
        out = []
        for i, row in enumerate(self.grid):
            lanes = self._lanes(i)
            out.append(Shard(grid.blocks[i], [copies[dev] for dev in row],
                             lane_tables[i], mask[lanes].to(row[0]),
                             mask_host[lanes]))
        return out

    def _store(self, grid: ShardGrid, dense) -> Tuple[object, int]:
        """The dispatch's result grid as the new dist: the grid itself, or
        a row-sparse dist re-packed from the slab (the blocks that are not
        views of it written back first). Returns ``(dist, host_reads)``."""
        if dense is None:
            return grid, 0
        for i, row in enumerate(grid.blocks):
            for m, b in enumerate(row):
                view = dense[self._lanes(i), :, self._cols(m)]
                if b.device != view.device or b.data_ptr() != view.data_ptr():
                    view.copy_(b)
        sd = self._arrays.dist
        return _from_dense(dense, sd.dist_cap, sd.ovf_cap, sd.lost)

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
                sum(int(r[3].fell_back) for r in res))
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

    def ingest_batch(self, src, dst, lab, ts, mask, ts_floor: float,
                     tables: QueryTables) -> torch.Tensor:
        """One ingest dispatch: fold the batch into the adjacency, run
        every shard's closure (dense, or frontier with per-shard fallback),
        emit per shard. Returns the (Q, N, N) new-validity matrix on the
        first device."""
        if self.adj_layout == "ell":
            self._reserve_spill(len(src))
        if self.dist_layout == "row_sparse":
            self._reserve_dist(self.frontier != "off")
        host = HostBatch(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                         np.asarray(lab, np.int64), np.asarray(mask, bool))
        src_t, dst_t, lab_t, ts_t, mask_t = self._batch(
            host.src, host.dst, host.lab, np.asarray(ts, np.float32), host.mask)
        adj, now = apply_batch(self._arrays, src_t, dst_t, lab_t, ts_t, mask_t,
                               _f32(ts_floor, self.device), host)
        grid, dense = self._dist_blocks()
        res, syncs, fstats = self._closures(self._shards(grid, adj, tables),
                                            tables, src_t, mask_t, now, delete=False)
        grid = _result_grid(res, grid.shape)
        valid = self._valid(grid, tables, now - tables.windows)
        new = []
        for v_row, e_row in zip(valid, self._arrays.emitted.blocks):
            new.append([v & ~e for v, e in zip(v_row, e_row)])
            for v, e in zip(v_row, e_row):
                e.logical_or_(v)
        dist, reads = self._store(grid, dense)
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
        host = HostBatch(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                         np.asarray(lab, np.int64), np.asarray(mask, bool))
        src_t, dst_t, lab_t, mask_t = self._batch(host.src, host.dst,
                                                  host.lab, host.mask)
        now = torch.maximum(self.now, _f32(ts_now, self.device))
        low = now - tables.windows
        grid, dense = self._dist_blocks()
        before = self._valid(grid, tables, low)
        adj = drop_batch(self._arrays, src_t, dst_t, lab_t, mask_t, host)
        res, syncs, fstats = self._closures(self._shards(grid, adj, tables),
                                            tables, src_t, mask_t, now, delete=True)
        grid = _result_grid(res, grid.shape)
        after = self._valid(grid, tables, low)
        invalidated = [[b & ~a for b, a in zip(b_row, a_row)]
                       for b_row, a_row in zip(before, after)]
        dist, reads = self._store(grid, dense)
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
        grid, dense = self._dist_blocks()
        shards = self._shards(grid, self._arrays.adj, tables, query_mask)
        res, syncs = shards_closure(shards, self.backend, 0, self.now,
                                    _f32(tables.max_window, self.device))
        dist, reads = self._store(_result_grid(res, grid.shape), dense)
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
