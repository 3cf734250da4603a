"""Row-sparse dist: per-source-row reachable sets plus a bounded overflow
table — the counterpart of ``repro.core.sparse_dist``.

Each ``(q, x)`` source row of the ``(Q, N, N, K)`` closure state is an
independent single-source problem, and on a sparse window almost every
``(v, k)`` entry of a row is -inf. So per row the layout keeps at most
``dist_cap`` reachable entries (``idx``/``ts`` slot pairs, ``idx`` the
flattened ``v * K + k`` key), where ``dist_cap`` is a power of two that
only doubles. A row that outgrows its slots moves to the overflow table
(``ovf_rows`` row ids plus full dense ``ovf_ts`` rows) inside the same
dispatch; the executor keeps a host budget of claims since the last
drain and re-packs (``dist_cap`` x2) before the table can fill, so the
layout equals the dense slab at every observable point. A row lives
either in its slots or in the table; free slots hold ``ts == -inf`` and
a stale ``idx``, which every max fold and threshold read ignores.

Leaves are torch tensors with the JAX package's dtypes (int32 keys and
counters, float32 timestamps), and every function writes the slot
positions the reference writes (claims in flattened ``q * N + x`` row
order, ranks by cumulative count), so the tests compare the raw leaves
of both packages, stale ``idx`` of free slots included. JAX's
``mode="drop"`` scatters become writes whose dropped entries repeat a
kept write (:func:`_copy_rows_drop`) or land in a sink one past the end
that is cut off (:func:`_flags`, and the slot compaction in
:func:`rsd_scatter_rows`).

The dispatch-path functions (gather, scatter, seed, emit, clears) make
no host read and update the state in place where the JAX executor
donates it. :func:`rsd_from_dense` (the dense fallback's re-pack) and
:func:`rsd_grow_repack` (the drain's re-pack) read counts to the host to
size their writes; ``_from_dense`` reports how many reads it made.
:func:`rsd_empty_np` and :func:`pack_rows` are the host-side numpy copies
of the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import device_get

NEG_INF = float("-inf")


class RowSparseDist(NamedTuple):
    """Row-sparse closure state (tensors on one device)."""

    idx: torch.Tensor       # (Q, N, C) int32 — flattened v * K + k key per slot
    ts: torch.Tensor        # (Q, N, C) f32   — entry timestamp; -inf = free
    ovf_rows: torch.Tensor  # (R,) int32 — flattened q * N + x row id; -1 = free
    ovf_ts: torch.Tensor    # (R, N*K) f32 — full dense overflow rows
    ovf_ptr: torch.Tensor   # () int32 — claim cursor; host budget keeps < R
    lost: torch.Tensor      # () int32 — rows dropped with the table full

    @property
    def n_lanes(self) -> int:
        return self.idx.shape[0]

    @property
    def n_slots(self) -> int:
        return self.idx.shape[1]

    @property
    def dist_cap(self) -> int:
        return self.idx.shape[2]

    @property
    def ovf_cap(self) -> int:
        return self.ovf_rows.shape[0]

    @property
    def k(self) -> int:
        return self.ovf_ts.shape[1] // self.idx.shape[1]


def rsd_empty_np(q: int, n: int, k: int, dist_cap: int,
                 ovf_cap: int) -> RowSparseDist:
    """Host-side empty row-sparse state (numpy leaves)."""
    return RowSparseDist(
        idx=np.zeros((q, n, dist_cap), np.int32),
        ts=np.full((q, n, dist_cap), NEG_INF, np.float32),
        ovf_rows=np.full((ovf_cap,), -1, np.int32),
        ovf_ts=np.full((ovf_cap, n * k), NEG_INF, np.float32),
        ovf_ptr=np.zeros((), np.int32),
        lost=np.zeros((), np.int32),
    )


def from_numpy(sd: RowSparseDist, device) -> RowSparseDist:
    """Numpy leaves -> tensors on ``device`` (dtypes kept), always copies:
    the dispatch updates the leaves in place."""
    return RowSparseDist(*[torch.tensor(np.asarray(x), device=device)
                           for x in sd])


def pack_rows(dense: np.ndarray, dist_cap: int,
              ovf_cap: int) -> RowSparseDist:
    """Host-side pack of a dense ``(Q, N, N, K)`` slab into row sets (numpy
    leaves): rows whose finite count fits ``dist_cap`` go to their slots
    in ascending key order, the rest to the overflow table in row order.
    Raises when more rows overflow than the table holds."""
    dense = np.asarray(dense, np.float32)
    q, n, _, k = dense.shape
    out = rsd_empty_np(q, n, k, dist_cap, ovf_cap)
    flat = dense.reshape(q, n, n * k)
    finite = flat > NEG_INF
    counts = finite.sum(-1)
    over_q, over_x = np.nonzero(counts > dist_cap)
    if over_q.size > ovf_cap:
        raise ValueError(
            f"pack_rows: {over_q.size} rows exceed dist_cap={dist_cap} but "
            f"ovf_cap={ovf_cap}; grow the capacity before packing")
    fit_q, fit_x, fit_e = np.nonzero(
        finite & (counts <= dist_cap)[:, :, None])
    if fit_q.size:
        rank = (np.cumsum(finite, axis=-1) - 1)[fit_q, fit_x, fit_e]
        out.idx[fit_q, fit_x, rank] = fit_e
        out.ts[fit_q, fit_x, rank] = flat[fit_q, fit_x, fit_e]
    if over_q.size:
        slots = np.arange(over_q.size)
        out.ovf_rows[slots] = over_q.astype(np.int64) * n + over_x
        out.ovf_ts[slots] = flat[over_q, over_x]
        out.ovf_ptr[...] = over_q.size
    return out


# ---------------------------------------------------------------------------
# drop-scatter helpers
# ---------------------------------------------------------------------------


def _copy_rows_drop(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor,
                    keep: torch.Tensor) -> None:
    """``dst[index[i]] = src[i]`` for every i with ``keep[i]`` (the kept
    indices are distinct), in place; the other rows are dropped, as JAX's
    ``.at[].set(mode="drop")`` drops out-of-range ones. No host read: a
    dropped row repeats the first kept write (or rewrites ``dst[0]`` when
    none is kept), so every duplicate index writes equal values and the
    result does not depend on the order of the writes. The first kept row
    is gathered through a (1,) index: indexing with the 0-dim argmax
    itself would read it on the host."""
    first = keep.to(torch.uint8).argmax().reshape(1)
    any_kept = keep.any()
    index = index.long()
    fill_index = torch.where(any_kept, index.index_select(0, first), 0)
    fill_row = torch.where(any_kept, src.index_select(0, first), dst[:1])
    keep_b = keep.view(-1, *([1] * (src.dim() - 1)))
    dst.index_copy_(0, torch.where(keep, index, fill_index),
                    torch.where(keep_b, src, fill_row))


def _flags(size: int, index: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """(size,) bool, True at ``index[i]`` where ``cond[i]`` — a scatter-or
    into a buffer one longer, whose last entry takes every write that
    ``cond`` drops and is cut off."""
    out = torch.zeros((size + 1,), dtype=torch.bool, device=index.device)
    out.index_fill_(0, torch.where(cond, index.long(), size), True)
    return out[:size]


def _source_mask(src: torch.Tensor, smask: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) bool: the batch's unmasked source slots (masked slots index
    one past the end and are cut off, as JAX's ``mode="drop"``)."""
    idx = torch.where(smask, src, n)
    out = torch.zeros((n + 1,), dtype=torch.bool, device=src.device)
    return out.index_fill_(0, idx, True)[:n]


def _live_rows(sd: RowSparseDist) -> Tuple[torch.Tensor, torch.Tensor]:
    """(live (R,) bool, row (R,) int64): table entries in use and their
    flattened ``q * N + x`` row (0 for free entries)."""
    live = sd.ovf_rows >= 0
    return live, torch.where(live, sd.ovf_rows, 0).long()


# ---------------------------------------------------------------------------
# densify / re-pack
# ---------------------------------------------------------------------------


def rsd_rows_to_dense(idx: torch.Tensor, ts: torch.Tensor,
                      ovf_rows: torch.Tensor, ovf_ts: torch.Tensor,
                      row0: int = 0) -> torch.Tensor:
    """Densify the rows ``[row0, row0 + M)`` of a row-sparse dist (flattened
    ``q * N + x`` row ids) from their slot rows ``idx``/``ts`` (M, C) and
    the overflow table, into an (M, N*K) view: slots and table rows
    max-folded (free slots and the slots-or-table split are no-ops); table
    rows outside the range, and free ones, land in a sink row cut off."""
    m = idx.shape[0]
    e = ovf_ts.shape[1]
    flat = torch.full((m + 1, e), NEG_INF, dtype=ts.dtype, device=ts.device)
    flat[:m].scatter_reduce_(1, idx.long(), ts, "amax", include_self=True)
    row = ovf_rows.long() - row0
    keep = (ovf_rows >= 0) & (row >= 0) & (row < m)
    flat.index_reduce_(0, torch.where(keep, row, m), ovf_ts, "amax",
                       include_self=True)
    return flat[:m]


def rsd_to_dense(sd: RowSparseDist) -> torch.Tensor:
    """Densify to the canonical ``(Q, N, N, K)`` slab."""
    q, n, c = sd.idx.shape
    flat = rsd_rows_to_dense(sd.idx.reshape(q * n, c), sd.ts.reshape(q * n, c),
                             sd.ovf_rows, sd.ovf_ts)
    return flat.view(q, n, n, sd.k)


def _pack_slots(flat: torch.Tensor, counts: torch.Tensor, counts_h: np.ndarray,
                dist_cap: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The slot leaves of (q, N, E) dense rows with finite counts ``counts``
    (and their host copy): rows that fit pack their entries by rank, lane
    by lane (the (N, E) finite mask and the entry coordinates of one lane
    at a time, never int64 ranks over the whole slab). Returns ``(idx, ts,
    reads)``, one read per lane with fitting entries (its ``nonzero``)."""
    q, n, _e = flat.shape
    dev = flat.device
    fits = counts <= dist_cap
    idx = torch.zeros((q, n, dist_cap), dtype=torch.int32, device=dev)
    ts = torch.full((q, n, dist_cap), NEG_INF, dtype=flat.dtype, device=dev)
    reads = 0
    for lane in range(q):
        if not ((counts_h[lane] > 0) & (counts_h[lane] <= dist_cap)).any():
            continue
        x, col = ((flat[lane] > NEG_INF) & fits[lane][:, None]).nonzero(  # repro: noqa[R1] the re-pack's one read a lane (the reference packs inside jit), counted in host_syncs
            as_tuple=True)                                        # row-major
        reads += 1
        cnt = torch.where(fits[lane], counts[lane], 0)
        start = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(x.shape[0], device=dev) - start[x]
        idx[lane, x, rank] = col.to(torch.int32)
        ts[lane, x, rank] = flat[lane, x, col]
    return idx, ts, reads


def rsd_pack_rows(flats: Sequence[torch.Tensor], dist_cap: int, ovf_cap: int,
                  lost: Optional[torch.Tensor], home: torch.device):
    """The re-pack of a dense dist held as consecutive lane ranges, each a
    (q_i, N, N*K) tensor on its own device (one range: the whole slab):
    each range's slot leaves on its device, and ONE overflow table on
    ``home`` whose rows are claimed in the flattened ``q * N + x`` order of
    the whole slab, so the leaves do not depend on the split. Returns
    ``(idx list, ts list, (ovf_rows, ovf_ts, ovf_ptr, lost), reads)``: one
    read for every range's (q_i, N) row counts together, one per lane with
    fitting entries."""
    counts = [torch.stack([(f[lane] > NEG_INF).sum(dim=1)
                           for lane in range(f.shape[0])]) for f in flats]
    counts_h = device_get(torch.cat([c.to(home) for c in counts]), "repack")  # repro: noqa[R1] the re-pack's row counts, one read (the reference packs inside jit), counted in host_syncs
    reads = 1
    n, e = flats[0].shape[1], flats[0].shape[2]
    idx, ts = [], []
    q0 = 0
    for f, c in zip(flats, counts):
        i, t, r = _pack_slots(f, c, counts_h[q0:q0 + f.shape[0]], dist_cap)
        idx.append(i)
        ts.append(t)
        reads += r
        q0 += f.shape[0]
    # overflowing rows claim table slots in flattened row order
    over = np.flatnonzero(counts_h.reshape(-1) > dist_cap)
    kept = over[:ovf_cap]
    ovf_rows = torch.full((ovf_cap,), -1, dtype=torch.int32, device=home)
    ovf_ts = torch.full((ovf_cap, e), NEG_INF, dtype=flats[0].dtype,
                        device=home)
    ovf_rows[:kept.size] = torch.as_tensor(kept, dtype=torch.int32).to(
        home, non_blocking=True)
    row0 = pos = 0
    for f in flats:
        mine = kept[(kept >= row0) & (kept < row0 + f.shape[0] * n)]
        if mine.size:
            sel = torch.as_tensor(mine - row0, dtype=torch.int64).to(
                f.device, non_blocking=True)
            ovf_ts[pos:pos + mine.size] = f.reshape(-1, e).index_select(
                0, sel).to(home)
            pos += mine.size
        row0 += f.shape[0] * n
    # fills, not copies from the host (which would wait for the stream)
    dropped = torch.full((), max(over.size - ovf_cap, 0), dtype=torch.int32,
                         device=home)
    ptr = torch.full((), min(over.size, ovf_cap), dtype=torch.int32, device=home)
    return (idx, ts, (ovf_rows, ovf_ts, ptr,
                      dropped if lost is None else lost.to(home) + dropped),
            reads)


def _from_dense(dense: torch.Tensor, dist_cap: int, ovf_cap: int,
                lost: Optional[torch.Tensor] = None
                ) -> Tuple[RowSparseDist, int]:
    """:func:`rsd_from_dense` plus the number of blocking host reads it
    made (see :func:`rsd_pack_rows`)."""
    q, n, _, k = dense.shape
    idx, ts, table, reads = rsd_pack_rows([dense.reshape(q, n, n * k)],
                                          dist_cap, ovf_cap, lost, dense.device)
    return RowSparseDist(idx[0], ts[0], *table), reads


def rsd_from_dense(dense: torch.Tensor, dist_cap: int, ovf_cap: int,
                   lost: Optional[torch.Tensor] = None) -> RowSparseDist:
    """Re-pack a dense ``(Q, N, N, K)`` slab — the tail of every dense
    path (the frontier fallback, the non-frontier round trip): fitting
    rows pack their finite entries into slots by rank, overflowing rows
    claim table slots in row order, and rows beyond ``ovf_cap`` are
    counted into ``lost`` (the host budget keeps that unreachable)."""
    return _from_dense(dense, dist_cap, ovf_cap, lost)[0]


def rsd_empty_like(sd: RowSparseDist) -> RowSparseDist:
    """Every row cleared (new tensors): the from-scratch start of the
    dense delete path. ``lost`` is kept; ``idx`` is left stale."""
    return sd._replace(ts=torch.full_like(sd.ts, NEG_INF),
                       ovf_rows=torch.full_like(sd.ovf_rows, -1),
                       ovf_ts=torch.full_like(sd.ovf_ts, NEG_INF),
                       ovf_ptr=torch.zeros_like(sd.ovf_ptr))


def rsd_grow_repack(sd: RowSparseDist, dist_cap: int,
                    ovf_cap: int) -> RowSparseDist:
    """Re-pack into grown capacities without densifying (new tensors): slot
    rows copy over, live table rows whose finite count now fits move into
    their slots, the rest re-claim compacted table positions. Densify
    before == densify after. Reads the fitting table entries' and the
    remaining rows' positions to the host (a drain-time path)."""
    q, n, c = sd.idx.shape
    e = sd.ovf_ts.shape[1]
    dev = sd.idx.device
    idx = torch.zeros((q, n, dist_cap), dtype=torch.int32, device=dev)
    ts = torch.full((q, n, dist_cap), NEG_INF, dtype=sd.ts.dtype, device=dev)
    idx[:, :, :c] = sd.idx
    ts[:, :, :c] = sd.ts
    live, row = _live_rows(sd)
    finite = (sd.ovf_ts > NEG_INF) & live[:, None]               # (R, E)
    counts = finite.sum(dim=1)
    fits = live & (counts <= dist_cap)
    r_i, col = (finite & fits[:, None]).nonzero(as_tuple=True)   # row-major
    cnt = torch.where(fits, counts, 0)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(r_i.shape[0], device=dev) - start[r_i]
    idx.view(q * n, dist_cap)[row[r_i], rank] = col.to(torch.int32)
    ts.view(q * n, dist_cap)[row[r_i], rank] = sd.ovf_ts[r_i, col]
    overs = live & ~fits
    opos = torch.cumsum(overs, 0) - 1
    sel = (overs & (opos < ovf_cap)).nonzero().squeeze(1)
    ovf_rows = torch.full((ovf_cap,), -1, dtype=torch.int32, device=dev)
    ovf_ts = torch.full((ovf_cap, e), NEG_INF, dtype=sd.ovf_ts.dtype,
                        device=dev)
    ovf_rows[opos[sel]] = sd.ovf_rows[sel]
    ovf_ts[opos[sel]] = sd.ovf_ts[sel]
    return RowSparseDist(idx, ts, ovf_rows, ovf_ts,
                         overs.sum().to(torch.int32), sd.lost)


# ---------------------------------------------------------------------------
# the frontier dispatch: gather once, scatter once
# ---------------------------------------------------------------------------


def _ovf_lookup(sd: RowSparseDist, key: torch.Tensor):
    """Table membership of flattened row keys (any shape): ``(has, slot)``.
    Free entries (-1) never match (keys are >= 0); compares every key
    with every table entry, so callers pass frontier-sized keys."""
    match = key[..., None] == sd.ovf_rows
    return match.any(dim=-1), match.to(torch.uint8).argmax(dim=-1)


def _row_keys(q: int, n: int, rows: torch.Tensor) -> torch.Tensor:
    """(Q, F) int64 flattened ``q * N + rows[q, f]`` keys."""
    return torch.arange(q, device=rows.device)[:, None] * n + rows.long()


def rsd_gather_rows(sd: RowSparseDist, rows: torch.Tensor,
                    gather_fn) -> torch.Tensor:
    """Densify the frontier rows: ``out[q, f] == dense[q, rows[q, f]]``,
    shape (Q, F, N, K). ``gather_fn(idx, ts, e) -> (M, E)`` densifies the
    gathered slot rows (the backend's ``gather_dist_rows``: kernel B6 on
    the card); table rows fold in afterwards (at most one hit per row)."""
    q, n, c = sd.idx.shape
    e = sd.ovf_ts.shape[1]
    f = rows.shape[1]
    key = _row_keys(q, n, rows)
    flat_key = key.reshape(-1)
    sid = sd.idx.view(q * n, c).index_select(0, flat_key)         # (Q*F, C)
    sts = sd.ts.view(q * n, c).index_select(0, flat_key)
    flat = gather_fn(sid, sts, e).view(q, f, e)
    has, oslot = _ovf_lookup(sd, key)
    flat = torch.where(has[:, :, None],
                       torch.maximum(flat, sd.ovf_ts[oslot]), flat)
    return flat.view(q, f, n, e // n)


def rsd_scatter_rows(sd: RowSparseDist, rows: torch.Tensor,
                     rowmask: torch.Tensor, slab: torch.Tensor) -> RowSparseDist:
    """Write relaxed frontier rows back, in place on the leaves; each valid
    ``(q, f)`` of ``slab`` is the complete new row ``rows[q, f]``, so the
    write is a full-row overwrite, exact when a row shrinks:

    * rows already in the table overwrite their table row;
    * rows whose finite count fits ``dist_cap`` overwrite their slots
      (cleared first, so stale higher-ranked entries die);
    * rows newly exceeding ``dist_cap`` claim table slots at the cursor
      (their slots are cleared);
    * claims past the table's end drop the row and count into ``lost``.

    Valid rows are distinct per lane (:func:`pack_frontier` packs a mask),
    so the kept writes never collide; padding slots are dropped."""
    q, f, n, k = slab.shape
    e = n * k
    c = sd.idx.shape[2]
    r = sd.ovf_rows.shape[0]
    m = q * f
    flat = slab.reshape(m, e)
    finite = flat > NEG_INF
    counts = finite.sum(dim=1)                                    # (M,)
    fits = counts <= c
    key = _row_keys(q, n, rows).reshape(-1)
    valid = rowmask.reshape(-1)
    in_ovf, oslot = _ovf_lookup(sd, key)
    # -- table writes: an existing entry, or a fresh claim in row order
    new_claim = valid & ~fits & ~in_ovf
    claim = sd.ovf_ptr + torch.cumsum(new_claim, 0) - 1
    dest = torch.where(in_ovf, oslot, claim)
    write_ovf = valid & (in_ovf | ~fits) & (dest < r)
    _copy_rows_drop(sd.ovf_rows, dest, key.to(torch.int32), write_ovf)
    _copy_rows_drop(sd.ovf_ts, dest, flat, write_ovf)
    n_new = new_claim.sum().to(torch.int32)
    dropped = (new_claim & (claim >= r)).sum().to(torch.int32)
    # -- slot writes: every valid row is cleared; fitting rows not in the
    # table take their finite entries by rank (a compaction into C slots
    # plus a sink column for everything else)
    pos = torch.where(finite & fits[:, None], torch.cumsum(finite, 1) - 1, c)
    cols = torch.arange(e, dtype=torch.int32, device=flat.device)
    comp_idx = torch.zeros((m, c + 1), dtype=torch.int32, device=flat.device)
    comp_idx.scatter_(1, pos, cols.expand(m, e))
    comp_ts = torch.full((m, c + 1), NEG_INF, dtype=flat.dtype,
                         device=flat.device)
    comp_ts.scatter_(1, pos, flat)
    written = ((valid & fits & ~in_ovf)[:, None]
               & (torch.arange(c, device=flat.device)[None, :] < counts[:, None]))
    idx_rows = sd.idx.view(q * n, c)
    new_idx = torch.where(written, comp_idx[:, :c],
                          idx_rows.index_select(0, key))
    new_ts = torch.where(written, comp_ts[:, :c], NEG_INF)
    _copy_rows_drop(idx_rows, key, new_idx, valid)
    _copy_rows_drop(sd.ts.view(q * n, c), key, new_ts, valid)
    return sd._replace(ovf_ptr=torch.clamp(sd.ovf_ptr + n_new, max=r),
                       lost=sd.lost + dropped)


# ---------------------------------------------------------------------------
# reads: seed, emit, counts
# ---------------------------------------------------------------------------


def rsd_seed_gathered(sd: RowSparseDist, src: torch.Tensor, smask: torch.Tensor,
                      query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, N) dirty-row mask of a batch, walking stored entries only: the
    row-sparse twin of the dense ``frontier_seed`` (the same mask), in
    O(Q·N·C + R·B·K) instead of O(Q·N²·K)."""
    q, n, _c = sd.idx.shape
    k = sd.k
    src_mask = _source_mask(src, smask, n)
    hit = (sd.ts > NEG_INF) & src_mask[(sd.idx // k).long()]
    reach = hit.any(dim=-1)                                       # (Q, N)
    live, row = _live_rows(sd)
    # table rows: their entries in the batch's source columns only
    cols = sd.ovf_ts.view(-1, n, k).index_select(1, torch.where(smask, src, 0))
    hit_r = ((cols > NEG_INF) & smask[None, :, None]).flatten(1).any(dim=1)
    reach = reach | _flags(q * n, row, hit_r & live).view(q, n)
    dirty = reach | src_mask[None, :]
    if query_mask is not None:
        dirty = dirty & query_mask[:, None]
    return dirty


def rsd_valid_pairs(sd: RowSparseDist, finals: torch.Tensor,
                    low: torch.Tensor) -> torch.Tensor:
    """(Q, N, N) bool validity per query — the sparse emit: slot entries
    set their (q, x, v) cell where the state is final and the timestamp
    clears the window threshold, table rows reduce their dense row once.
    Equals the dense ``batched_valid_pairs`` of :func:`rsd_to_dense`."""
    q, n, c = sd.idx.shape
    k = sd.k
    key = sd.idx.long()
    ok = (finals.gather(1, (key % k).view(q, n * c)).view(q, n, c)
          & (sd.ts > low[:, None, None]))
    cell = ((torch.arange(q * n, device=key.device).view(q, n, 1)) * n
            + key // k)
    valid = _flags(q * n * n, cell.view(-1), ok.view(-1)).view(q, n, n)
    live, row = _live_rows(sd)
    q_r = row // n
    ok_r = ((sd.ovf_ts.view(-1, n, k) > low[q_r][:, None, None])
            & finals[q_r][:, None, :]).any(dim=2)                 # (R, N)
    vrows = valid.view(q * n, n)
    _copy_rows_drop(vrows, row, vrows.index_select(0, row) | ok_r, live)
    return valid


def rsd_row_counts(sd: RowSparseDist) -> torch.Tensor:
    """(Q, N) int32 finite-entry count per row (slots + table): sizes
    ``dist_cap`` growth at a drain."""
    n = sd.idx.shape[1]
    counts = (sd.ts > NEG_INF).sum(dim=-1).to(torch.int32)
    live, row = _live_rows(sd)
    ovf_counts = torch.where(live, (sd.ovf_ts > NEG_INF).sum(dim=-1), 0)
    counts.view(-1).index_add_(0, row, ovf_counts.to(torch.int32))
    return counts.view(-1, n)


def rsd_live_entries(sd: RowSparseDist) -> torch.Tensor:
    """Device count of finite entries (read at drains, like
    ``ell_live_edges``)."""
    live = sd.ovf_rows >= 0
    return ((sd.ts > NEG_INF).sum().to(torch.int32)
            + ((sd.ovf_ts > NEG_INF) & live[:, None]).sum().to(torch.int32))


# ---------------------------------------------------------------------------
# maintenance: clears (in place)
# ---------------------------------------------------------------------------


def rsd_clear_slots(sd: RowSparseDist, dead: torch.Tensor) -> RowSparseDist:
    """Clear every entry whose source or destination vertex slot is dead
    (``dead``: (N,) bool), in place: the dense row-and-column clear."""
    n = sd.idx.shape[1]
    k = sd.k
    sd.ts.masked_fill_(dead[None, :, None], NEG_INF)              # source rows
    sd.ts.masked_fill_(dead[(sd.idx // k).long()], NEG_INF)       # dest entries
    live, row = _live_rows(sd)
    ovf = sd.ovf_ts.view(-1, n, k)
    ovf.masked_fill_(dead[None, :, None], NEG_INF)                # dest slots
    ovf.masked_fill_((dead[row % n] & live)[:, None, None], NEG_INF)
    return sd


def rsd_clear_lane(sd: RowSparseDist, lane: int) -> RowSparseDist:
    """Clear one query lane, in place (the dense ``dist[lane] = -inf``); its
    table entries keep their row ids with -inf rows, as in the reference."""
    n = sd.idx.shape[1]
    sd.ts[lane] = NEG_INF
    hit = (sd.ovf_rows >= 0) & (sd.ovf_rows.long() // n == lane)
    sd.ovf_ts.masked_fill_(hit[:, None], NEG_INF)
    return sd
