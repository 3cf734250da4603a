"""Blocked-sparse adjacency: padded ELL rows plus a spill ring — the
counterpart of ``repro.core.sparse_adj``.

Per ``(label, u)`` row the layout keeps at most ``ell_cap`` destination
slots (``idx``/``ts`` pairs, ELLPACK), where ``ell_cap`` is a power of two
that only ever doubles. A row that is full sends the surplus edge to a
small spill ring (``spill_src/dst/lab/ts`` and the append cursor
``spill_ptr``) inside the same dispatch; the executor keeps a host budget
of appends since the last drain and re-packs before the ring can wrap, so
the layout is bit-identical to the dense ``(L, N, N)`` slab at every event.

Free slots hold ``ts == -inf``; their ``idx`` may be stale, which is
benign everywhere: contraction and densify fold with max, so a -inf
candidate is a no-op; deletes clear every matching copy; expiry
thresholds each copy on its own. For the same reason an edge held both in
a row slot and in the ring never changes a result.

Leaves are torch tensors on the executor's device with the JAX package's
dtypes (int32 indices, float32 timestamps), so the tests compare the raw
leaves of both packages. :func:`ell_insert` and :func:`ell_delete` take the
batch's ``src``/``dst``/``lab``/``mask`` as host values (numpy arrays or
CPU tensors): the slot and ring decisions that depend on the device state
stay on the device, and no event costs a host sync. Everything else runs
on the device; :func:`ell_empty_np` and :func:`pack_ell` are the host-side
numpy copies of the reference's, and :func:`pack_ell_dense` is the same
pack on the device (for re-packs and growth, which keep the state on the
card).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")


class EllAdjacency(NamedTuple):
    """Padded-ELL adjacency + spill ring (tensors on one device)."""

    idx: torch.Tensor        # (L, N, E) int32 — destination vertex per slot
    ts: torch.Tensor         # (L, N, E) f32   — edge timestamp; -inf = free
    spill_src: torch.Tensor  # (S,) int32
    spill_dst: torch.Tensor  # (S,) int32
    spill_lab: torch.Tensor  # (S,) int32
    spill_ts: torch.Tensor   # (S,) f32        — -inf = free ring entry
    spill_ptr: torch.Tensor  # ()   int32 — append cursor; host budget keeps < S

    @property
    def n_labels(self) -> int:
        return self.idx.shape[0]

    @property
    def n_slots(self) -> int:
        return self.idx.shape[1]

    @property
    def ell_cap(self) -> int:
        return self.idx.shape[2]

    @property
    def spill_cap(self) -> int:
        return self.spill_src.shape[0]


def ell_empty_np(n_labels: int, n_slots: int, ell_cap: int,
                 spill_cap: int) -> EllAdjacency:
    """Host-side empty ELL state (numpy leaves)."""
    return EllAdjacency(
        idx=np.zeros((n_labels, n_slots, ell_cap), np.int32),
        ts=np.full((n_labels, n_slots, ell_cap), NEG_INF, np.float32),
        spill_src=np.zeros((spill_cap,), np.int32),
        spill_dst=np.zeros((spill_cap,), np.int32),
        spill_lab=np.zeros((spill_cap,), np.int32),
        spill_ts=np.full((spill_cap,), NEG_INF, np.float32),
        spill_ptr=np.zeros((), np.int32),
    )


def from_numpy(ell: EllAdjacency, device) -> EllAdjacency:
    """Numpy leaves -> tensors on ``device`` (dtypes kept)."""
    return EllAdjacency(*[torch.as_tensor(np.asarray(x)).to(device)
                          for x in ell])


def pack_ell(dense: np.ndarray, ell_cap: int, spill_cap: int) -> EllAdjacency:
    """Host-side pack of a dense ``(L, N, N)`` slab into ELL rows (numpy
    leaves): each row's live edges in ascending destination order in its
    first slots. The caller sizes ``ell_cap`` to at least the max live
    out-degree, so a pack never needs the ring; an overfull row raises."""
    dense = np.asarray(dense, np.float32)
    n_labels, n_slots, _ = dense.shape
    out = ell_empty_np(n_labels, n_slots, ell_cap, spill_cap)
    live = dense > NEG_INF
    l, u, v = np.nonzero(live)
    if l.size:
        deg = live.sum(-1).reshape(-1)
        row_start = np.zeros(n_labels * n_slots + 1, np.int64)
        np.cumsum(deg, out=row_start[1:])
        flat = l.astype(np.int64) * n_slots + u
        pos = np.arange(l.size, dtype=np.int64) - row_start[flat]
        if pos.max() >= ell_cap:
            raise ValueError(
                f"pack_ell: max out-degree {int(pos.max()) + 1} exceeds "
                f"ell_cap={ell_cap}; grow the capacity before packing")
        out.idx[l, u, pos] = v
        out.ts[l, u, pos] = dense[l, u, v]
    return out


def pack_ell_dense(dense: torch.Tensor, ell_cap: int,
                   spill_cap: int) -> EllAdjacency:
    """:func:`pack_ell` on the device: the same slots, in the same order,
    from a dense ``(L, N, N)`` tensor (one host read: the live count)."""
    n_labels, n_slots, _ = dense.shape
    dev = dense.device
    idx = torch.zeros((n_labels, n_slots, ell_cap), dtype=torch.int32,
                      device=dev)
    ts = torch.full((n_labels, n_slots, ell_cap), NEG_INF,
                    dtype=torch.float32, device=dev)
    live = dense > NEG_INF
    nz = torch.nonzero(live)                    # row-major, as np.nonzero
    if nz.shape[0]:
        l, u, v = nz.unbind(1)
        deg = live.sum(-1).reshape(-1)
        row_start = torch.zeros(n_labels * n_slots + 1, dtype=torch.int64,
                                device=dev)
        torch.cumsum(deg, 0, out=row_start[1:])
        flat = l * n_slots + u
        pos = torch.arange(nz.shape[0], device=dev) - row_start[flat]
        top = int(pos.max())
        if top >= ell_cap:
            raise ValueError(
                f"pack_ell: max out-degree {top + 1} exceeds "
                f"ell_cap={ell_cap}; grow the capacity before packing")
        idx[l, u, pos] = v.to(torch.int32)
        ts[l, u, pos] = dense[l, u, v]
    return _with_empty_ring(idx, ts, spill_cap)


def _with_empty_ring(idx: torch.Tensor, ts: torch.Tensor,
                     spill_cap: int) -> EllAdjacency:
    """Row slots and an empty spill ring of ``spill_cap`` entries."""
    dev = idx.device

    def zeros(dtype):
        return torch.zeros((spill_cap,), dtype=dtype, device=dev)

    return EllAdjacency(
        idx=idx, ts=ts, spill_src=zeros(torch.int32),
        spill_dst=zeros(torch.int32), spill_lab=zeros(torch.int32),
        spill_ts=torch.full((spill_cap,), NEG_INF, dtype=torch.float32,
                            device=dev),
        spill_ptr=torch.zeros((), dtype=torch.int32, device=dev))


def ell_to_dense(ell: EllAdjacency, zero: float = NEG_INF) -> torch.Tensor:
    """Densify to the canonical ``(L, N, N)`` slab: the max over every
    stored copy (row slots and ring) of each edge."""
    n = ell.n_slots
    return ell_block_to_dense(ell, slice(0, n), slice(0, n), zero)


def ell_block_to_dense(ell: EllAdjacency, rows: slice, cols: slice,
                       zero: float = NEG_INF) -> torch.Tensor:
    """The (L, R, C) block ``ell_to_dense(ell, zero)[:, rows, cols]`` (a
    model peer's u-row or v-column view), densified from the row slots of
    ``rows`` and the ring without the whole slab. Entries outside the
    block scatter -inf at offset 0, a no-op under max."""
    n_labels = ell.n_labels
    r0, c0 = rows.start, cols.start
    n_r, n_c = rows.stop - r0, cols.stop - c0
    dev = ell.ts.device
    out = torch.full((n_labels, n_r, n_c), zero, dtype=ell.ts.dtype,
                     device=dev)
    idx = ell.idx[:, rows].long()                              # (L, R, E)
    ok = (idx >= c0) & (idx < cols.stop)
    cells = torch.arange(n_labels * n_r, device=dev).view(n_labels, n_r, 1)
    flat = torch.where(ok, cells * n_c + idx - c0, 0)
    out.view(-1).scatter_reduce_(
        0, flat.reshape(-1), torch.where(ok, ell.ts[:, rows], NEG_INF).reshape(-1),
        "amax", include_self=True)
    src, dst = ell.spill_src.long(), ell.spill_dst.long()
    ok = (src >= r0) & (src < rows.stop) & (dst >= c0) & (dst < cols.stop)
    ring = (ell.spill_lab.long() * n_r + src - r0) * n_c + dst - c0
    out.view(-1).scatter_reduce_(0, torch.where(ok, ring, 0),
                                 torch.where(ok, ell.spill_ts, NEG_INF),
                                 "amax", include_self=True)
    return out


def ell_live_entries(ell: EllAdjacency):
    """The canonical slab's live edges without the slab: ``(keys, ts)``,
    the ascending flattened ``(l * N + u) * N + v`` keys of every edge with
    a live copy (row slot or ring) and each one's max timestamp, the
    entries of ``ell_to_dense(ell) > -inf`` in row-major order. Reads the
    live count to the host (a re-pack path)."""
    n_labels, n_slots, e_cap = ell.idx.shape
    dev = ell.idx.device
    rows = torch.arange(n_labels * n_slots, device=dev)
    keys = torch.cat([
        (rows[:, None] * n_slots + ell.idx.reshape(-1, e_cap).long()).reshape(-1),
        (ell.spill_lab.long() * n_slots + ell.spill_src.long()) * n_slots
        + ell.spill_dst.long()])
    ts = torch.cat([ell.ts.reshape(-1), ell.spill_ts])
    live = ts > NEG_INF
    keys, ts = keys[live], ts[live]
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    best = torch.full(uniq.shape, NEG_INF, dtype=ts.dtype, device=dev)
    return uniq, best.scatter_reduce_(0, inv, ts, "amax", include_self=True)


def ell_entries_degree(keys: torch.Tensor, n_labels: int,
                       n_slots: int) -> int:
    """Max out-degree over ``(label, u)`` rows of :func:`ell_live_entries`'
    keys (a host read)."""
    if not keys.numel():
        return 0
    return int(torch.bincount(keys // n_slots,
                              minlength=n_labels * n_slots).max())


def pack_ell_entries(keys: torch.Tensor, ts: torch.Tensor, n_labels: int,
                     n_slots: int, ell_cap: int,
                     spill_cap: int) -> EllAdjacency:
    """:func:`pack_ell_dense` of the slab whose live entries are ``keys``
    and ``ts`` (:func:`ell_live_entries`): the same slots in the same
    order, the ring empty, from O(L*N*E + S) entries instead of the
    (L, N, N) slab."""
    dev = ts.device
    idx = torch.zeros((n_labels * n_slots, ell_cap), dtype=torch.int32,
                      device=dev)
    out_ts = torch.full((n_labels * n_slots, ell_cap), NEG_INF,
                        dtype=torch.float32, device=dev)
    if keys.numel():
        row = keys // n_slots
        deg = torch.bincount(row, minlength=n_labels * n_slots)
        pos = torch.arange(keys.shape[0], device=dev) - (torch.cumsum(deg, 0)
                                                         - deg)[row]
        top = int(pos.max())
        if top >= ell_cap:
            raise ValueError(
                f"pack_ell: max out-degree {top + 1} exceeds "
                f"ell_cap={ell_cap}; grow the capacity before packing")
        idx[row, pos] = (keys % n_slots).to(torch.int32)
        out_ts[row, pos] = ts
    return _with_empty_ring(idx.view(n_labels, n_slots, ell_cap),
                            out_ts.view(n_labels, n_slots, ell_cap), spill_cap)


def _host_ints(x) -> list:
    return np.asarray(torch.as_tensor(x).cpu()).tolist()  # repro: noqa[R1] host columns: the executors pass HostBatch's numpy arrays, so .cpu() copies nothing


def ell_insert(ell: EllAdjacency, src, dst, lab, ts: torch.Tensor,
               mask) -> EllAdjacency:
    """Batch insert, event by event in batch order: max into an existing
    slot for ``(lab, src, dst)``, else claim the first free slot, else
    spill to the ring (merge if the triple is already there, append at
    ``spill_ptr`` otherwise). Returns a new state; the input is untouched.

    ``src``/``dst``/``lab``/``mask`` are host values; ``ts`` (B,) lies on
    the state's device. Masked events are no-ops, as in the reference. An
    append past the ring's end is dropped, as the reference's
    ``mode="drop"`` does; the executor's spill budget keeps the cursor
    below the capacity, so that never happens there.

    One deliberate difference from the reference: the ring match looks
    only at entries below ``spill_ptr``. The reference also matches the
    zero-filled free entries past the cursor, which read as the triple
    (slot 0, slot 0, label 0); an overflowing insert of that triple then
    "merges" into the entry at the cursor without advancing it, and the
    next append overwrites the edge (the dense slab keeps it). With no such
    insert the two are leaf for leaf the same."""
    cur = EllAdjacency(*[x.clone() for x in ell])
    e_cap, s_cap = cur.ell_cap, cur.spill_cap
    dev = cur.ts.device
    slots = torch.arange(e_cap, device=dev)
    ring_slots = torch.arange(s_cap, device=dev)
    us, vs, ls, ms = (_host_ints(x) for x in (src, dst, lab, mask))
    for i, (u, v, l, m) in enumerate(zip(us, vs, ls, ms)):
        if not m:
            continue
        t = ts[i]
        row_idx, row_ts = cur.idx[l, u], cur.ts[l, u]       # (E,) views
        row_hit = (row_idx == v) & (row_ts > NEG_INF)
        row_free = row_ts == NEG_INF
        has_hit, has_free = row_hit.any(), row_free.any()
        use_row = has_hit | has_free
        # argmax of an integer row is its first True (torch documents the
        # first maximal index), as jnp.argmax of a bool row
        slot = torch.where(has_hit, torch.argmax(row_hit.to(torch.int32)),
                           torch.argmax(row_free.to(torch.int32)))
        put = (slots == slot) & use_row
        row_idx.copy_(torch.where(put, v, row_idx))
        row_ts.copy_(torch.where(put, torch.maximum(row_ts, t), row_ts))

        do_spill = ~use_row
        # only entries below the cursor hold edges: the free tail is
        # zero-filled, i.e. it reads as the triple (0, 0, label 0)
        ring_hit = ((cur.spill_src == u) & (cur.spill_dst == v)
                    & (cur.spill_lab == l) & (ring_slots < cur.spill_ptr))
        any_ring = ring_hit.any()
        first = torch.argmax(ring_hit.to(torch.int32))
        wslot = torch.where(any_ring, first, cur.spill_ptr.long())
        ring_ts = cur.spill_ts.gather(0, first.reshape(1)).reshape(())
        new_ts = torch.where(any_ring, torch.maximum(ring_ts, t), t)
        wr = (ring_slots == wslot) & do_spill
        cur.spill_src.copy_(torch.where(wr, u, cur.spill_src))
        cur.spill_dst.copy_(torch.where(wr, v, cur.spill_dst))
        cur.spill_lab.copy_(torch.where(wr, l, cur.spill_lab))
        cur.spill_ts.copy_(torch.where(wr, new_ts, cur.spill_ts))
        cur.spill_ptr.add_((do_spill & ~any_ring).to(torch.int32))
    return cur


def ell_delete(ell: EllAdjacency, src, dst, lab, mask) -> EllAdjacency:
    """Batch delete: clear every row slot AND ring entry matching
    ``(lab, src, dst)`` (all copies die, as the dense ``set(-inf)``).
    Cleared slots keep their stale ``idx``. Clearing is idempotent and no
    event changes ``idx``, so the batch clears at once with the same
    result as the reference's event-by-event loop. Host ``src``/``dst``/
    ``lab``/``mask`` as in :func:`ell_insert`; returns a new state."""
    cur = EllAdjacency(*[x.clone() for x in ell])
    keep = np.asarray(torch.as_tensor(mask).cpu(), bool)  # repro: noqa[R1] host columns: the executors pass HostBatch's numpy arrays, so .cpu() copies nothing
    if not keep.any():
        return cur
    dev = cur.ts.device

    def sel(x):
        return torch.as_tensor(np.asarray(torch.as_tensor(x).cpu())[keep],  # repro: noqa[R1] host columns: the executors pass HostBatch's numpy arrays, so .cpu() copies nothing
                               dtype=torch.int64).to(dev, non_blocking=True)

    u, v, l = sel(src), sel(dst), sel(lab)
    n_slots, e_cap = cur.n_slots, cur.ell_cap
    hit = cur.idx[l, u].long() == v[:, None]                      # (B, E)
    base = (l * n_slots + u) * e_cap
    flat = (base[:, None] + torch.arange(e_cap, device=dev)).reshape(-1)
    clear = torch.where(hit, NEG_INF, float("inf")).reshape(-1)
    cur.ts.view(-1).scatter_reduce_(0, flat, clear.to(cur.ts.dtype), "amin",
                                    include_self=True)
    ring_hit = ((cur.spill_src.long()[None, :] == u[:, None])
                & (cur.spill_dst.long()[None, :] == v[:, None])
                & (cur.spill_lab.long()[None, :] == l[:, None])).any(0)
    cur.spill_ts.masked_fill_(ring_hit, NEG_INF)
    return cur


def ell_expire(ell: EllAdjacency, low: torch.Tensor) -> EllAdjacency:
    """Window expiry: threshold each timestamp leaf (mirrors the dense
    ``where(adj > low, adj, -inf)``)."""
    return ell._replace(
        ts=torch.where(ell.ts > low, ell.ts, NEG_INF),
        spill_ts=torch.where(ell.spill_ts > low, ell.spill_ts, NEG_INF))


def ell_incident(ell: EllAdjacency) -> torch.Tensor:
    """Per-vertex max incident timestamp, identical to the dense
    ``maximum(adj.amax((0, 2)), adj.amax((0, 1)))``."""
    n_slots = ell.n_slots
    out_u = ell.ts.amax(dim=(0, 2))
    in_v = torch.full((n_slots,), NEG_INF, dtype=ell.ts.dtype,
                      device=ell.ts.device)
    in_v.scatter_reduce_(0, ell.idx.reshape(-1).long(), ell.ts.reshape(-1),
                         "amax", include_self=True)
    out_u.scatter_reduce_(0, ell.spill_src.long(), ell.spill_ts, "amax",
                          include_self=True)
    in_v.scatter_reduce_(0, ell.spill_dst.long(), ell.spill_ts, "amax",
                         include_self=True)
    return torch.maximum(out_u, in_v)


def ell_clear_slots(ell: EllAdjacency, dead: torch.Tensor) -> EllAdjacency:
    """Clear every edge incident to a dead vertex slot (``dead``: (N,)
    bool), mirroring the dense row+column ``set(-inf)``."""
    ts = torch.where(dead[None, :, None], NEG_INF, ell.ts)
    ts = torch.where(dead[ell.idx.long()], NEG_INF, ts)
    kill = dead[ell.spill_src.long()] | dead[ell.spill_dst.long()]
    return ell._replace(ts=ts, spill_ts=torch.where(kill, NEG_INF,
                                                     ell.spill_ts))


def ell_live_edges(ell: EllAdjacency) -> torch.Tensor:
    """Device count of live (non-free) entries; ring duplicates of
    row-resident edges count once each."""
    return ((ell.ts > NEG_INF).sum().to(torch.int32)
            + (ell.spill_ts > NEG_INF).sum().to(torch.int32))


def ell_max_degree(ell: EllAdjacency) -> torch.Tensor:
    """Device max live out-degree over ``(label, u)`` rows, counting ring
    entries toward their row — sizes ``ell_cap`` after a drain."""
    row_deg = (ell.ts > NEG_INF).sum(dim=2).to(torch.int32)        # (L, N)
    ring_live = (ell.spill_ts > NEG_INF).to(torch.int32)
    flat = ell.spill_lab.long() * ell.n_slots + ell.spill_src.long()
    row_deg.view(-1).index_add_(0, flat, ring_live)
    return row_deg.max()


def ell_label_rows(ell: EllAdjacency, labs: torch.Tensor,
                   zero: float) -> torch.Tensor:
    """Densify the per-transition label slabs: ``out[j] == dense[labs[j]]``
    of shape (J, N, N) (the tests' view of the reference's base term; the
    round itself folds the base term straight off the slots)."""
    return ell_to_dense(ell, zero)[labs.long()]


def ell_rows_dense(ell: EllAdjacency, labs: torch.Tensor, rows: torch.Tensor,
                   zero: float) -> torch.Tensor:
    """Densify only the frontier rows: ``out[j, f] == dense[labs[j],
    rows[j, f]]`` of shape (J, F, N) — the O(F * d_max) base-term gather
    of the frontier round."""
    j, f = rows.shape
    n_slots = ell.n_slots
    labs_l, rows_l = labs.long(), rows.long()
    idx_r = ell.idx[labs_l[:, None], rows_l].long()      # (J, F, E)
    ts_r = ell.ts[labs_l[:, None], rows_l]
    out = torch.full((j, f, n_slots), zero, dtype=ell.ts.dtype,
                     device=ell.ts.device)
    out.scatter_reduce_(2, idx_r, ts_r, "amax", include_self=True)
    hit = ((ell.spill_lab.long()[None, None, :] == labs_l[:, None, None])
           & (ell.spill_src.long()[None, None, :] == rows_l[:, :, None]))
    eff = torch.where(hit, ell.spill_ts[None, None, :], zero)   # (J, F, S)
    dst = ell.spill_dst.long()[None, None, :].expand(hit.shape)
    out.scatter_reduce_(2, dst, eff, "amax", include_self=True)
    return out
