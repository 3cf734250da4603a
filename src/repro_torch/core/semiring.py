"""(max, min) bottleneck-semiring relaxation over the product graph —
``repro.core.semiring`` lines 55-1480: the legacy single-query round
(:class:`TransitionTable`, :func:`relax_round`, :func:`closure`,
:func:`valid_pairs`), and for a batch of queries the batched round and
closure over a dense or an ELL adjacency, the frontier-restricted closure
and deletion, both over the row-sparse dist
(:mod:`repro_torch.core.sparse_dist`), and the sharded rounds of the mesh
executor (:func:`shard_transitions`, :func:`shard_closure`,
:func:`shard_frontier_closure`, :func:`shard_frontier_delete`).

``dist[q, x, v, s]`` is the best (max over paths) bottleneck (min over
edges) timestamp of any path x -> v whose label drives query q's DFA from
its start state to s. One relaxation round applies every DFA transition
(s, l, t) of every query at once:

    out[q, x, v, t] max= max_u min(dist[q, x, u, s], adj[l, u, v])

plus the base term adj[l, x, v] for transitions out of the start state.
The per-query transition tables are flattened into one list (a
:class:`BatchedTransitionTable`), so a round is one gather, one batched
max-min contraction (kernel B1 on the card), one base-term fold and one
segment max into (query, destination state) slices.

The fixpoint loop is a Python loop: the JAX version runs it on the device
(``lax.while_loop``); here the host reads the per-lane changed flags once
per round, and :func:`batched_closure` reports how many such reads it
made so the executor can count host syncs per dispatch. Likewise the
frontier closure's in-dispatch dense fallback (a ``lax.cond`` in JAX) is a
host decision here, on one read of the per-lane frontier counts.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, device_get, resolve_device
from .contraction import Backend, BackendLike, resolve_backend
from .sparse_adj import EllAdjacency, ell_rows_dense
from .sparse_dist import (
    RowSparseDist,
    _from_dense,
    _source_mask,
    rsd_gather_rows,
    rsd_scatter_rows,
    rsd_seed_gathered,
    rsd_to_dense,
    rsd_valid_pairs,
)

NEG_INF = float("-inf")

#: bytes one chunk of the dense ELL round may hold in its two (chunk, N, N)
#: tensors, the gathered dist rows and their contraction: ~2 GiB, so a
#: round at N=8192 runs 4 transition rows a chunk and small ones one chunk
ELL_ROUND_BYTES = 2 << 30


# ---------------------------------------------------------------------------
# The legacy single-query round (reference: semiring.py:55-167)
#
# One query's (N, N, K) dist against its own (L, N, N) adjacency, one
# contraction per DFA transition through the backend's ``contract`` hook
# (kernel B2 with the "cuda" backend, B4 with the bucket backend). The
# reference's ``fori_loop`` over transitions is a Python loop here, one
# launch per transition; its ``while_loop`` fixpoint reads one changed
# flag per round on the host. Operands are in the backend's
# representation: callers of the bucket backend encode themselves.
# ---------------------------------------------------------------------------


class TransitionTable(NamedTuple):
    """Static DFA transition arrays (built once at query registration), on
    the query's device."""

    src: torch.Tensor         # (J,) int64 source state of each transition
    lab: torch.Tensor         # (J,) int64 label index
    dst: torch.Tensor         # (J,) int64 destination state
    dst_onehot: torch.Tensor  # (J, K) float32 one-hot of dst
    start_mask: torch.Tensor  # (J,) bool: src == s0
    k: int
    n_labels: int

    @staticmethod
    def from_dfa(dfa, device: DeviceLike = None) -> "TransitionTable":
        """The DFA's transitions in its own order; an empty language gets
        one inert row (0, 0, 0) that never fires (no start mask, an
        all-zero one-hot), as in the reference."""
        dev = resolve_device(device)

        def t(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        trans = dfa.transitions()
        if not trans:
            return TransitionTable(
                t([0]), t([0]), t([0]),
                t(np.zeros((1, max(dfa.k, 1)), np.float32), torch.float32),
                t([False], torch.bool), max(dfa.k, 1), max(dfa.n_labels, 1))
        src = np.array([s for (s, _l, _t) in trans], np.int64)
        dst = np.array([d for (_s, _l, d) in trans], np.int64)
        oh = np.zeros((len(trans), dfa.k), np.float32)
        oh[np.arange(len(trans)), dst] = 1.0
        return TransitionTable(
            src=t(src), lab=t([lab for (_s, lab, _t) in trans]), dst=t(dst),
            dst_onehot=t(oh, torch.float32),
            start_mask=t(src == dfa.start, torch.bool),
            k=dfa.k, n_labels=dfa.n_labels)


def relax_round(
    dist: torch.Tensor,          # (N, N, K) in the backend's representation
    adj: torch.Tensor,           # (L, N, N)
    tt: TransitionTable,
    backend: BackendLike = None,
) -> torch.Tensor:
    """One relaxation round; returns a new tensor, the pointwise max of
    dist and every transition's contribution (each contraction reads the
    round's input ``dist``, as the reference's loop does). One
    ``backend.contract`` call per transition; no host sync."""
    backend = resolve_backend(backend)
    n = dist.shape[0]
    out = dist.clone()
    for j in range(tt.src.shape[0]):
        dist_s = dist.index_select(2, tt.src[j:j + 1]).view(n, n)    # [x, u]
        adj_l = adj.index_select(0, tt.lab[j:j + 1]).view(n, n)     # [u, v]
        contrib = backend.contract(dist_s, adj_l)                    # [x, v]
        # base term: seed (x, x, s0) = +inf => min(+inf, adj[l, x, v]) = adj
        contrib = torch.where(tt.start_mask[j], torch.maximum(contrib, adj_l),
                              contrib)
        # max into the destination state's slice through the one-hot row
        # (the empty language's all-zero row writes nothing)
        upd = torch.where(tt.dst_onehot[j][None, None, :] > 0,
                          contrib[:, :, None], backend.zero)
        torch.maximum(out, upd, out=out)
    return out


def closure(
    dist: torch.Tensor,
    adj: torch.Tensor,
    tt: TransitionTable,
    backend: BackendLike = None,
    max_rounds: int = 0,
) -> Tuple[torch.Tensor, int]:
    """Iterate :func:`relax_round` to the fixpoint. Returns ``(dist,
    rounds)`` as the reference does (``rounds`` a Python int here).
    ``max_rounds=0`` bounds the loop by N*K + 1 rounds."""
    dist, rounds, _syncs = _single_closure(dist, adj, tt, backend, max_rounds)
    return dist, rounds


def _single_closure(dist, adj, tt, backend, max_rounds):
    """:func:`closure` plus the host-sync count: the reference's loop runs
    a first round, then rounds while the last one changed something; the
    host reads ``any(nd > d)`` once per later round."""
    backend = resolve_backend(backend)
    n, _, k = dist.shape
    bound = max_rounds if max_rounds > 0 else n * k + 1
    d = relax_round(dist, adj, tt, backend)
    rounds, syncs = 1, 0
    while rounds < bound:
        nd = relax_round(d, adj, tt, backend)
        rounds += 1
        changed = bool((nd > d).any())
        syncs += 1
        d = nd
        if not changed:
            break
    return d, rounds, syncs


def valid_pairs(dist: torch.Tensor, finals: torch.Tensor,
                low) -> torch.Tensor:
    """(N, N) bool: pair (x, v) has an accepting path inside the window,
    i.e. the max over final states of dist is above ``low`` (strict).
    ``finals`` is a (K,) bool mask."""
    best = dist.masked_fill(~finals[None, None, :], NEG_INF).amax(dim=2)
    return best > low


class BatchedTransitionTable(NamedTuple):
    """Flattened transition arrays of Q stacked DFAs (built at
    registration), on the engine's device.

    J = total transitions across all queries, rounded up to a bucket
    multiple, so that query mixes of similar size share one shape.
    Padding rows are inert (``active`` False: their contribution is the
    semiring zero); padded K states are inert because no transition
    scatters into them and finals masks pad False. ``start_idx`` lists the
    rows whose source is their query's start state (the rows that carry
    the base term), known on the host at construction."""

    qidx: torch.Tensor        # (J,) int64 owning query
    src: torch.Tensor         # (J,) int64 source DFA state (< k_q)
    lab: torch.Tensor         # (J,) int64 label index in the SHARED alphabet
    dst: torch.Tensor         # (J,) int64 destination DFA state
    start_mask: torch.Tensor  # (J,) bool: src == s0 of the owning query
    active: torch.Tensor      # (J,) bool: False for shape-padding rows
    start_idx: torch.Tensor   # (S,) int64 rows where start_mask is True
    n_queries: int
    k: int                    # K_max (padded per-query state count)
    n_labels: int             # |union alphabet|

    @staticmethod
    def from_dfas(
        dfas: Sequence, labels: Sequence[str],
        j_bucket: int = 8, k_bucket: int = 2, k_min: int = 1,
        device: DeviceLike = None,
    ) -> "BatchedTransitionTable":
        """Stack per-query DFAs over a shared label alphabet (same rows,
        same order, same padding as the JAX version). ``k_min`` floors the
        padded state count so a live engine's table never shrinks below
        its allocated dist axis."""
        dev = resolve_device(device)
        labels = tuple(labels)
        lab_index = {lab: i for i, lab in enumerate(labels)}
        k_max = max([d.k for d in dfas] + [1, k_min])
        k_max += (-k_max) % k_bucket
        qidx, src, lab, dst, start = [], [], [], [], []
        for q, dfa in enumerate(dfas):
            for (s, li, t) in dfa.transitions():
                qidx.append(q)
                src.append(s)
                lab.append(lab_index[dfa.labels[li]])
                dst.append(t)
                start.append(s == dfa.start)
        n_active = len(qidx)
        n_rows = max(n_active + (-n_active) % j_bucket, j_bucket)
        pad = n_rows - n_active
        qidx += [0] * pad
        src += [0] * pad
        lab += [0] * pad
        dst += [0] * pad
        start += [False] * pad
        start_np = np.array(start, bool)

        def t(x, dtype=torch.int64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        return BatchedTransitionTable(
            qidx=t(qidx), src=t(src), lab=t(lab), dst=t(dst),
            start_mask=t(start_np, torch.bool),
            active=t([True] * n_active + [False] * pad, torch.bool),
            start_idx=t(np.nonzero(start_np)[0]),
            n_queries=len(dfas),
            k=k_max,
            n_labels=max(len(labels), 1),
        )


def _round_update(dist: torch.Tensor, adj: torch.Tensor,
                  btt: BatchedTransitionTable, backend: Backend,
                  query_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One round's contributions as a (Q, N, N, K) view: the gathered
    contraction, the base term on active start rows, and the segment max
    into (query, dst-state) slices. Rows of masked queries carry -inf, so
    masked lanes receive nothing."""
    q, n, _, k = dist.shape
    active = btt.active
    if query_mask is not None:
        active = active & query_mask[btt.qidx]
    # base term: seed (x, x, s0) = +inf => min(+inf, adj[l, x, v]) = adj,
    # applied only to ACTIVE start rows so it cannot unmask a zeroed row
    s = btt.start_idx
    # segment max over qidx * K + dst; empty segments hold the dtype
    # minimum, as jax.ops.segment_max fills them (-inf for floats, below
    # every level for the bucket backend's int32)
    seg = btt.qidx * k + btt.dst
    if isinstance(adj, EllAdjacency):
        scat = _segment_buffer(q * k, n, dist)
        _ell_round_chunks(scat, dist, adj, btt, backend, active, seg,
                          bool(s.numel()))
        return scat.view(q, k, n, n).permute(0, 2, 3, 1)
    contrib = backend.contract_batched(dist, adj, btt, active)  # (J, N, N)
    if s.numel():
        sub = contrib.index_select(0, s)
        base = adj.index_select(0, btt.lab.index_select(0, s))
        sub = torch.where(active.index_select(0, s)[:, None, None],
                          torch.maximum(sub, base), sub)
        contrib.index_copy_(0, s, sub)
        del sub, base
    return _segment_max(contrib, seg, q, k)


def _segment_buffer(segments: int, n: int, dist: torch.Tensor) -> torch.Tensor:
    """The (segments, N, N) segment-max buffer, filled with the dtype
    minimum."""
    return torch.full((segments, n, n), _dtype_min(dist.dtype),
                      dtype=dist.dtype, device=dist.device)


def _segment_max(contrib: torch.Tensor, seg: torch.Tensor, q: int,
                 k: int) -> torch.Tensor:
    """Segment max of (J, M, C) contributions into (q * k) segments, as a
    (Q, M, C, K) view; empty segments hold the dtype minimum."""
    _j, m, c = contrib.shape
    scat = torch.full((q * k, m, c), _dtype_min(contrib.dtype),
                      dtype=contrib.dtype, device=contrib.device)
    scat.index_reduce_(0, seg, contrib, "amax", include_self=True)
    return scat.view(q, k, m, c).permute(0, 2, 3, 1)


def ell_round_chunk(j: int, n: int, itemsize: int = 4) -> int:
    """Transition rows a chunk of the dense ELL round holds: as many as
    keep its gathered rows and their contraction, two (chunk, N, N)
    tensors, within :data:`ELL_ROUND_BYTES`; at least 1, at most J."""
    return max(1, min(j, ELL_ROUND_BYTES // max(1, 2 * n * n * itemsize)))


def ell_round_launches(j: int, n: int, itemsize: int = 4) -> int:
    """Contractions (kernel B5's launches on the card) one dense ELL
    round of J transition rows over N slots makes: one per chunk."""
    return -(-j // ell_round_chunk(j, n, itemsize))


def _ell_round_chunks(scat, dist, adj: EllAdjacency,
                      btt: BatchedTransitionTable, backend: Backend,
                      active, seg, has_base: bool) -> None:
    """The dense round's ELL contraction folded into ``scat`` chunk by
    chunk over the J transition rows (:func:`ell_round_chunk`): per
    chunk the gather of ``dist[qidx, :, :, src]``, one contraction, the
    masking and the base term on its active start rows, and the segment
    max. Max never reassociates, so any chunking is bit-identical to one
    chunk."""
    j_rows, n = btt.qidx.shape[0], dist.shape[1]
    step = ell_round_chunk(j_rows, n, dist.element_size())
    base_rows = btt.start_mask & active
    for j0 in range(0, j_rows, step):
        rows = slice(j0, min(j_rows, j0 + step))
        # advanced indices split by slices go first, as in numpy and JAX
        d_s = dist[btt.qidx[rows], :, :, btt.src[rows]]        # (c, N, N)
        contrib = backend.contract_rows_ell(d_s, adj, btt.lab[rows])
        del d_s
        contrib.masked_fill_(~active[rows, None, None], backend.zero)
        if has_base:
            _fold_base_ell(contrib, adj,
                           torch.arange(contrib.shape[0], device=dist.device),
                           btt.lab[rows], base_rows[rows], backend.zero)
        scat.index_reduce_(0, seg[rows], contrib, "amax", include_self=True)
        del contrib


def _dtype_min(dtype: torch.dtype):
    """The smallest value of ``dtype`` (-inf for floats), the fill of
    ``jax.ops.segment_max``'s empty segments."""
    return NEG_INF if dtype.is_floating_point else torch.iinfo(dtype).min


def _fold_base_ell(contrib: torch.Tensor, ell: EllAdjacency,
                   rows: torch.Tensor, labs: torch.Tensor,
                   active: torch.Tensor, zero) -> None:
    """``contrib[rows[i]] max= dense(ell)[labs[i]]`` for the active rows,
    in place, straight off the ELL slots and the ring: the same values as
    the reference's densified ``ell_label_rows`` folded with max, without
    materializing a (J, N, N) slab. Inactive rows fold the backend's
    ``zero``, which changes nothing."""
    _j, n, _ = contrib.shape
    dev = contrib.device
    flat_out = contrib.view(-1)
    x = torch.arange(n, device=dev)
    ts = torch.where(active[:, None, None], ell.ts[labs], zero)     # (S, N, E)
    flat = ((rows[:, None, None] * n + x[None, :, None]) * n
            + ell.idx[labs].long())
    flat_out.scatter_reduce_(0, flat.reshape(-1), ts.reshape(-1), "amax",
                             include_self=True)
    hit = (ell.spill_lab.long()[None, :] == labs[:, None]) & active[:, None]
    ring = torch.where(hit, ell.spill_ts[None, :], zero)             # (S, R)
    flat = ((rows[:, None] * n + ell.spill_src.long()[None, :]) * n
            + ell.spill_dst.long()[None, :])
    flat_out.scatter_reduce_(0, flat.reshape(-1), ring.reshape(-1), "amax",
                             include_self=True)


def batched_relax_round(
    dist: torch.Tensor,          # (Q, N, N, K)
    adj,                         # (L, N, N) shared adjacency or EllAdjacency
    btt: BatchedTransitionTable,
    backend: BackendLike = None,
    query_mask: Optional[torch.Tensor] = None,   # (Q,) bool, True = relax
) -> torch.Tensor:
    """One relaxation round over all queries' transitions; returns a new
    tensor, the pointwise max of dist and the round's contributions.
    Lanes masked out by ``query_mask`` pass through untouched."""
    backend = resolve_backend(backend)
    out = torch.maximum(dist, _round_update(dist, adj, btt, backend,
                                            query_mask))
    if query_mask is not None:
        out = torch.where(query_mask[:, None, None, None], out, dist)
    return out


def _relax_in_place(dist: torch.Tensor, adj: torch.Tensor,
                    btt: BatchedTransitionTable, backend: Backend,
                    mask: torch.Tensor) -> torch.Tensor:
    """One masked round applied to ``dist`` in place; returns the (Q,)
    lanes that changed (a device tensor: no sync). Masked lanes receive
    only -inf, so the in-place max leaves them as they were."""
    q = dist.shape[0]
    upd = _round_update(dist, adj, btt, backend, mask)
    changed = (upd > dist).reshape(q, -1).any(dim=1)
    torch.maximum(dist, upd, out=dist)
    return mask & changed


def _masked_closure_loop(
    dist_op: torch.Tensor,
    adj_op: torch.Tensor,
    btt: BatchedTransitionTable,
    backend: Backend,
    mask0: torch.Tensor,
    bound: int,
) -> Tuple[torch.Tensor, int, torch.Tensor, int]:
    """The convergence-masked fixpoint loop, in place on ``dist_op``.

    Same rounds as the JAX ``lax.while_loop``: round 1 relaxes the lanes
    of ``mask0``; each later round relaxes only the lanes the previous
    round changed, until none changed or ``bound`` rounds ran. After every
    round the host reads the changed flags once (``changed.any()``), so
    the loop makes exactly ``rounds`` host syncs. Returns
    ``(dist, rounds, query_rounds, host_syncs)``; ``rounds`` is a Python
    int, ``query_rounds`` a (Q,) int32 device tensor."""
    changed = _relax_in_place(dist_op, adj_op, btt, backend, mask0)
    query_rounds = mask0.to(torch.int32)
    rounds, syncs = 1, 0
    while True:
        syncs += 1
        if not bool(changed.any()) or rounds >= bound:  # repro: noqa[R1] the fixpoint loop's one read a round (the reference's lax.while_loop), counted in host_syncs
            break
        mask = changed
        changed = _relax_in_place(dist_op, adj_op, btt, backend, mask)
        query_rounds += mask
        rounds += 1
    return dist_op, rounds, query_rounds, syncs


def batched_closure(
    dist: torch.Tensor,
    adj: torch.Tensor,
    btt: BatchedTransitionTable,
    backend: BackendLike = None,
    max_rounds: int = 0,
    query_mask: Optional[torch.Tensor] = None,   # (Q,) bool initial mask
    now: Optional[torch.Tensor] = None,          # () stream clock
    w_max: Optional[torch.Tensor] = None,        # () group's largest window
) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Iterate batched relaxation to the fixpoint with per-query
    convergence masking (see :func:`_masked_closure_loop`).

    ``dist`` is updated IN PLACE and returned: the JAX executor donates
    its dist buffer to the same loop (``donate_argnums``), and at N=2048
    a copy is 0.8 GB. Callers that still need the input pass a clone.

    Returns ``(dist, rounds, query_rounds)`` as the JAX version does:
    ``rounds`` is the global round count (a Python int here: the host
    drove the loop), ``query_rounds`` the (Q,) int32 per-query count of
    rounds each query actively relaxed."""
    dist, rounds, query_rounds, _syncs = _closure(
        dist, adj, btt, backend, max_rounds, query_mask, now, w_max)
    return dist, rounds, query_rounds


def _closure(dist, adj, btt, backend, max_rounds, query_mask, now, w_max):
    """:func:`batched_closure` plus the host-sync count. A
    :class:`RowSparseDist` takes the reference's dense round trip:
    densify, the same dense loop, re-pack (its reads count as syncs)."""
    if isinstance(dist, RowSparseDist):
        dense, rounds, qrounds, syncs = _closure(
            rsd_to_dense(dist), adj, btt, backend, max_rounds, query_mask,
            now, w_max)
        out, reads = _from_dense(dense, dist.dist_cap, dist.ovf_cap, dist.lost)
        return out, rounds, qrounds, syncs + reads
    backend = resolve_backend(backend)
    q, n, _, k = dist.shape
    bound = max_rounds if max_rounds > 0 else n * k + 1
    mask0 = (torch.ones((q,), dtype=torch.bool, device=dist.device)
             if query_mask is None else query_mask.to(torch.bool))
    dist_op, adj_op = backend.prepare_state(dist, adj, now, w_max)
    dist_f, rounds, query_rounds, syncs = _masked_closure_loop(
        dist_op, adj_op, btt, backend, mask0, bound)
    return backend.decode_state(dist_f, now, w_max), rounds, query_rounds, syncs


def batched_valid_pairs(
    dist: torch.Tensor, finals: torch.Tensor, low: torch.Tensor
) -> torch.Tensor:
    """(Q, N, N) bool validity per query: ``finals`` is (Q, K), ``low``
    is (Q,) (per-query window thresholds applied at read time; strict >).
    A :class:`RowSparseDist` takes the sparse emit (:func:`rsd_valid_pairs`),
    which reduces only the stored entries."""
    if isinstance(dist, RowSparseDist):
        return rsd_valid_pairs(dist, finals, low)
    best = dist.masked_fill(~finals[:, None, None, :], NEG_INF).amax(dim=3)
    return best > low[:, None, None]


# ---------------------------------------------------------------------------
# Frontier-restricted relaxation and deletion (reference: semiring.py:409-819)
#
# The (max, min) recurrence couples dist[q, x, v, t] only to dist[q, x, u, s]
# — the same source row x — so a closure at its fixpoint before a batch can
# only change on the rows the batch dirties: rows x = an inserted edge's
# source (the base term) and rows already reaching one with a finite entry.
# A round restricted to those rows reaches the dense fixpoint exactly, rows
# that stop changing drop out, and when some lane's dirty set overflows the
# frontier capacity F the dispatch runs the dense loop instead. For a
# deletion the same reduction over the pre-delete state is the deleted
# edges' cone: those rows are cleared and re-derived, the rest keep their
# values (equal on every entry above the window threshold; only window-dead
# entries may differ from a dense from-scratch re-closure).
#
# Differences from the JAX version, none of them visible in the results:
# the fallback is chosen on the host from one read of the per-lane counts
# (JAX: lax.cond on the device), the frontier loop reads the changed-row
# count once per round (JAX: lax.while_loop), so every FrontierStats field
# is a host value; and dist is updated in place, as the JAX executor
# donates it.
# ---------------------------------------------------------------------------


class FrontierStats(NamedTuple):
    """Per-dispatch frontier telemetry (host values)."""

    seed_rows: int        # dirty rows across all lanes
    max_lane_rows: int    # largest single-lane frontier
    rows_relaxed: int     # sum over rounds of rows relaxed
    fell_back: bool       # dense fallback taken (overflow)


def frontier_seed(
    dist: torch.Tensor,          # (Q, N, N, K) f32 timestamps
    src: torch.Tensor,           # (B,) int64 inserted-edge source slots
    smask: torch.Tensor,         # (B,) bool batch padding mask
    query_mask: Optional[torch.Tensor] = None,   # (Q,) bool live lanes
) -> torch.Tensor:
    """(Q, N) bool dirty-row mask for a batch of inserted edges: rows
    x = src (base term) plus rows with a finite entry reaching an inserted
    edge's source in any DFA state (the O(Q·N²·K) scan)."""
    n = dist.shape[1]
    src_mask = _source_mask(src, smask, n)
    finite = (dist > NEG_INF).any(dim=3)                     # (Q, N, N)
    reach = (finite & src_mask[None, None, :]).any(dim=2)    # (Q, N)
    dirty = reach | src_mask[None, :]
    if query_mask is not None:
        dirty = dirty & query_mask[:, None]
    return dirty


def frontier_seed_gathered(
    dist: torch.Tensor,
    src: torch.Tensor,
    smask: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`frontier_seed` with the O(N²) scan replaced by a gather of
    the batch's B source columns (O(Q·N·B·K)); the same mask exactly. The
    ELL layout seeds with it, the dense layout keeps the scan, as in the
    reference."""
    n = dist.shape[1]
    cols = dist.index_select(2, torch.where(smask, src, 0))  # (Q, N, B, K)
    reach = ((cols > NEG_INF) & smask[None, None, :, None]).any(dim=3).any(dim=2)
    dirty = reach | _source_mask(src, smask, n)[None, :]
    if query_mask is not None:
        dirty = dirty & query_mask[:, None]
    return dirty


def delete_cone(dist, src, smask, query_mask=None) -> torch.Tensor:
    """(Q, N) bool invalidation cone of a batch of deleted edges on the
    PRE-delete state: the same reduction as :func:`frontier_seed`."""
    return frontier_seed(dist, src, smask, query_mask)


def pack_frontier(
    dirty: torch.Tensor, f_cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact a (Q, N) dirty mask into per-lane row indices: ``(rows,
    rowmask, counts)`` with rows (Q, F) int64 (the first ``min(count, F)``
    slots hold the dirty rows in ascending order, padding is 0), rowmask
    (Q, F) bool, counts (Q,) int32 of the TRUE dirty rows (counts > F is
    an overflow: the surplus rows are dropped here, so callers fall back
    to the dense loop). The rows are scattered into a buffer one column
    wider, whose last column takes every dropped write and is cut off."""
    q, n = dirty.shape
    cnt = dirty.sum(dim=1).to(torch.int32)
    pos = torch.cumsum(dirty, dim=1) - 1
    pos = torch.where(dirty, torch.clamp(pos, max=f_cap), f_cap)
    rows = torch.zeros((q, f_cap + 1), dtype=torch.int64, device=dirty.device)
    rows.scatter_(1, pos, torch.arange(n, device=dirty.device).expand(q, n))
    rowmask = (torch.arange(f_cap, device=dirty.device)[None, :]
               < torch.clamp(cnt, max=f_cap)[:, None])
    return rows[:, :f_cap], rowmask, cnt


def _frontier_slab_round(
    slab: torch.Tensor,          # (Q, F, N, K) gathered frontier rows
    adj,                         # (L, N, N) dense adjacency or EllAdjacency
    btt: BatchedTransitionTable,
    backend: Backend,
    rows: torch.Tensor,          # (Q, F) int64 frontier row indices
    rowmask: torch.Tensor,       # (Q, F) bool valid-slot mask
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frontier round on the gathered slab (no scatter back): the
    contraction through the backend (kernel B1 on skinny (F, N) slabs with
    a dense adjacency, kernel B5 with an ELL one), the base term at the
    frontier rows, masking and the segment max. Returns ``(new_slab,
    changed)`` with changed (Q, F) intersected with ``rowmask``."""
    q, f, n, k = slab.shape
    slab_s = slab[btt.qidx, :, :, btt.src].contiguous()     # (J, F, N) [f, u]
    rows_j = rows[btt.qidx]                                  # (J, F)
    if isinstance(adj, EllAdjacency):
        contrib = backend.contract_rows_ell(slab_s, adj, btt.lab)
        a_base = ell_rows_dense(adj, btt.lab, rows_j, backend.zero)
    else:
        a_l = adj[btt.lab]                                   # (J, N, N)
        contrib = backend.contract_rows(slab_s, a_l)         # (J, F, N)
        a_base = a_l.gather(1, rows_j[:, :, None].expand(-1, -1, n))
        del a_l
    del slab_s
    base_rows = btt.start_mask & btt.active
    contrib = torch.where(base_rows[:, None, None],
                          torch.maximum(contrib, a_base), contrib)
    act = btt.active[:, None] & rowmask[btt.qidx]            # (J, F)
    contrib = contrib.masked_fill_(~act[:, :, None], backend.zero)
    upd = _segment_max(contrib, btt.qidx * k + btt.dst, q, k)  # (Q, F, N, K)
    new_slab = torch.maximum(slab, upd)
    changed = (new_slab > slab).flatten(2).any(dim=2) & rowmask
    return new_slab, changed


def frontier_relax_round(
    dist: torch.Tensor,          # (Q, N, N, K), updated IN PLACE
    adj,
    btt: BatchedTransitionTable,
    backend: BackendLike,
    rows: torch.Tensor,          # (Q, F) frontier row indices
    rowmask: torch.Tensor,       # (Q, F) bool valid-slot mask
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One relaxation round restricted to the frontier rows: gather the
    (Q, F, N, K) slab, run :func:`_frontier_slab_round`, and max-scatter
    the slab back into ``dist`` (in place; returned). Padded slots repeat
    row 0 of their lane, which can also be a valid row of the same lane:
    the max-scatter folds both, as JAX's ``.at[].max`` does, where a plain
    indexed write could keep the stale copy. Returns ``(dist, changed)``."""
    backend = resolve_backend(backend)
    q, n = dist.shape[0], dist.shape[1]
    f = rows.shape[1]
    flat = (torch.arange(q, device=dist.device)[:, None] * n + rows).reshape(-1)
    rows2d = dist.view(q * n, -1)
    slab = rows2d.index_select(0, flat).view(q, f, n, -1)
    new_slab, changed = _frontier_slab_round(slab, adj, btt, backend, rows,
                                             rowmask)
    rows2d.index_reduce_(0, flat, new_slab.reshape(q * f, -1), "amax",
                         include_self=True)
    return dist, changed


def _frontier_loop(state, step, rowmask0, n_active: int, bound: int):
    """The frontier rounds of one dispatch: round 1 relaxes ``rowmask0``
    (``n_active`` rows, known on the host), each later round the rows the
    previous one changed, until none changed or ``bound`` rounds ran.
    ``step(state, rowmask) -> (state, changed)`` is one round (on the
    dense dist, or on the row-sparse path's gathered slab). One host read
    per round (the changed-row count). Returns ``(state, rounds,
    query_rounds, rows_relaxed, host_syncs)``."""
    q = rowmask0.shape[0]
    qrounds = torch.zeros((q,), dtype=torch.int32, device=rowmask0.device)
    rm = rowmask0
    rounds = rows_relaxed = syncs = 0
    while n_active > 0 and rounds < bound:
        qrounds += rm.any(dim=1).to(torch.int32)
        state, rm = step(state, rm)
        rows_relaxed += n_active
        rounds += 1
        if rounds < bound:
            n_active = int(device_get(rm.sum()))  # repro: noqa[R1] the frontier loop's changed-row count, one read a round (lax.while_loop), counted in host_syncs
            syncs += 1
    return state, rounds, qrounds, rows_relaxed, syncs


def _frontier(dist, adj, btt, backend, src, smask, f_cap, query_mask,
              max_rounds, now, w_max, delete: bool):
    """:func:`frontier_closure` (``delete=False``) and
    :func:`frontier_delete` (``delete=True``) plus the host-sync count."""
    if isinstance(dist, RowSparseDist):
        return _rowsparse_frontier(dist, adj, btt, backend, src, smask, f_cap,
                                   query_mask, max_rounds, now, w_max, delete)
    backend = resolve_backend(backend)
    q, n, _, k = dist.shape
    bound = max_rounds if max_rounds > 0 else n * k + 1
    mask0 = (torch.ones((q,), dtype=torch.bool, device=dist.device)
             if query_mask is None else query_mask.to(torch.bool))
    # ELL seeds by the batch-column gather, dense keeps the scan: the same
    # mask either way, so the overflow decision is layout-independent
    seed_fn = (frontier_seed_gathered if isinstance(adj, EllAdjacency)
               else frontier_seed)
    dirty = seed_fn(dist, src, smask, mask0)
    rows, rowmask0, cnt_h, live_lanes, overflow = _plan(dirty, f_cap, mask0)
    syncs = 1
    if delete:
        # the cone's rows, or every row on the fallback, re-derive from -inf
        if overflow:
            dist.fill_(NEG_INF)
        else:
            dist.masked_fill_(dirty[:, :, None, None], NEG_INF)
    dist_op, adj_op = backend.prepare_state(dist, adj, now, w_max)
    if overflow:
        dist_f, rounds, qrounds, loop_syncs = _masked_closure_loop(
            dist_op, adj_op, btt, backend, mask0, bound)
        rows_relaxed = rounds * live_lanes * n
    else:
        n_active = int(np.minimum(cnt_h, f_cap).sum())

        def step(d, rm):
            return frontier_relax_round(d, adj_op, btt, backend, rows, rm)

        dist_f, rounds, qrounds, rows_relaxed, loop_syncs = _frontier_loop(
            dist_op, step, rowmask0, n_active, bound)
    stats = FrontierStats(int(cnt_h.sum()), int(cnt_h.max()), rows_relaxed,
                          overflow)
    return (backend.decode_state(dist_f, now, w_max), rounds, qrounds, stats,
            syncs + loop_syncs)


def _plan(dirty: torch.Tensor, f_cap: int, mask0: torch.Tensor):
    """Pack the dirty mask and take the one host read that replaces the
    reference's ``lax.cond``: the per-lane counts and the live lanes.
    Returns ``(rows, rowmask0, counts (host), live_lanes, overflow)``."""
    q = dirty.shape[0]
    rows, rowmask0, cnt = pack_frontier(dirty, f_cap)
    host = device_get(torch.cat([cnt.to(torch.int64), mask0.sum().reshape(1)]))  # repro: noqa[R1] the fallback decision (the reference's lax.cond), one read a dispatch, counted in host_syncs
    cnt_h = host[:q]
    return rows, rowmask0, cnt_h, int(host[q]), bool((cnt_h > f_cap).any())


# ---------------------------------------------------------------------------
# The frontier paths over the row-sparse dist (reference: semiring.py:826-1012)
#
# The same contracts as the dense-dist functions above. A dispatch reads
# and writes only the frontier rows, so the row-sparse path densifies them
# once (the backend's gather_dist_rows: kernel B6 on the card), runs every
# round on that slab, and scatters the finished rows back once. A delete
# starts its cone rows from a -inf slab and gathers nothing. On overflow
# the dispatch takes the dense round trip: densify, the exact dense loop,
# re-pack (rows that outgrow dist_cap land in the overflow table, which
# the executor's budget drains before it fills).
# ---------------------------------------------------------------------------


def _rowsparse_frontier(sd: RowSparseDist, adj, btt, backend, src, smask,
                        f_cap, query_mask, max_rounds, now, w_max,
                        delete: bool):
    """:func:`_frontier` on a :class:`RowSparseDist`: the same return
    contract, with the re-pack's reads counted among the host syncs. The
    seed walks the stored entries of the (pre-delete) state; a delete's
    final scatter overwrites every cone row whole, which is its clear."""
    backend = resolve_backend(backend)
    q, n, _c = sd.idx.shape
    k = sd.k
    bound = max_rounds if max_rounds > 0 else n * k + 1
    dev = sd.ts.device
    mask0 = (torch.ones((q,), dtype=torch.bool, device=dev)
             if query_mask is None else query_mask.to(torch.bool))
    dirty = rsd_seed_gathered(sd, src, smask, mask0)
    rows, rowmask0, cnt_h, live_lanes, overflow = _plan(dirty, f_cap, mask0)
    syncs = 1
    _, adj_op = backend.prepare_state(None, adj, now, w_max)
    if overflow:
        dense = (torch.full((q, n, n, k), NEG_INF, dtype=torch.float32,
                            device=dev)
                 if delete else rsd_to_dense(sd))
        d_op, _ = backend.prepare_state(dense, None, now, w_max)
        d_f, rounds, qrounds, loop_syncs = _masked_closure_loop(
            d_op, adj_op, btt, backend, mask0, bound)
        out, reads = _from_dense(backend.decode_state(d_f, now, w_max),
                                 sd.dist_cap, sd.ovf_cap, sd.lost)
        del d_f, d_op, dense
        rows_relaxed = rounds * live_lanes * n
        syncs += reads
    else:
        if delete:
            # cone rows re-derive from scratch: rounds read only slab rows
            slab0 = torch.full((q, f_cap, n, k), NEG_INF, dtype=torch.float32,
                               device=dev)
        else:
            slab0 = rsd_gather_rows(sd, rows, backend.gather_dist_rows)
        slab_op, _ = backend.prepare_state(slab0, None, now, w_max)

        def step(s, rm):
            return _frontier_slab_round(s, adj_op, btt, backend, rows, rm)

        n_active = int(np.minimum(cnt_h, f_cap).sum())
        s_f, rounds, qrounds, rows_relaxed, loop_syncs = _frontier_loop(
            slab_op, step, rowmask0, n_active, bound)
        out = rsd_scatter_rows(sd, rows, rowmask0,
                               backend.decode_state(s_f, now, w_max))
    stats = FrontierStats(int(cnt_h.sum()), int(cnt_h.max()), rows_relaxed,
                          overflow)
    return out, rounds, qrounds, stats, syncs + loop_syncs


def frontier_closure(
    dist: torch.Tensor,
    adj,
    btt: BatchedTransitionTable,
    backend: BackendLike,
    src: torch.Tensor,           # (B,) inserted-edge source slots
    smask: torch.Tensor,         # (B,) bool batch padding mask
    f_cap: int,                  # frontier capacity (bucketed ×2)
    query_mask: Optional[torch.Tensor] = None,
    max_rounds: int = 0,
    now: Optional[torch.Tensor] = None,
    w_max: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor, FrontierStats]:
    """Frontier-restricted closure with the dense fallback: seed from the
    batch, iterate frontier rounds until every row settles, or run the
    exact dense masked loop when any lane's dirty set overflows ``f_cap``.
    ``dist`` is updated IN PLACE and returned; results are bit-identical
    to :func:`batched_closure` either way.

    Returns ``(dist, rounds, query_rounds, stats)`` as the JAX version:
    ``query_rounds`` counts the rounds a lane had a non-empty frontier (a
    lane the batch never dirtied counts zero)."""
    dist, rounds, qrounds, stats, _ = _frontier(
        dist, adj, btt, backend, src, smask, f_cap, query_mask, max_rounds,
        now, w_max, delete=False)
    return dist, rounds, qrounds, stats


def frontier_delete(
    dist: torch.Tensor,          # PRE-delete state, updated IN PLACE
    adj,                         # RETAINED adjacency (edges dropped)
    btt: BatchedTransitionTable,
    backend: BackendLike,
    src: torch.Tensor,
    smask: torch.Tensor,
    f_cap: int,
    query_mask: Optional[torch.Tensor] = None,
    max_rounds: int = 0,
    now: Optional[torch.Tensor] = None,
    w_max: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int, torch.Tensor, FrontierStats]:
    """Cone-seeded re-derivation after a batch of deletions: the deleted
    edges' cone on the pre-delete ``dist`` is cleared to -inf and
    re-derived by the frontier rounds; on cone overflow every row is
    cleared and the dense from-scratch loop runs (what the non-frontier
    delete computes). Same return contract as :func:`frontier_closure`."""
    dist, rounds, qrounds, stats, _ = _frontier(
        dist, adj, btt, backend, src, smask, f_cap, query_mask, max_rounds,
        now, w_max, delete=True)
    return dist, rounds, qrounds, stats


# ---------------------------------------------------------------------------
# Sharded rounds (reference: semiring.py:1000-1480)
#
# The mesh executor (repro_torch.distributed.executor) block-partitions the
# lanes over the data axis of its device grid and, optionally, the third
# axis of dist (v, the u of the next round's contraction) over the model
# axis. A lane shard relaxes only its own lanes' transition rows (a
# per-shard BatchedTransitionTable with shard-local lane indices, from
# shard_tables) to ITS OWN fixpoint, and skips the dispatch when none of
# its lanes is live (or, on the frontier path, dirty). The model peers of
# a lane shard each contract their own u block; their (J, M, N) partials
# fold with max onto the first peer and each peer keeps its v columns:
# the reference's pmax, exact because max never reassociates. The changed
# flags fold the same way, so the peers of a shard agree on every round.
#
# Differences from the JAX version, none visible in the results: the
# per-shard lax.cond skip is a host decision (the executor's host mirror
# of the query mask, or the one read of every shard's frontier counts),
# the while_loop is a host round loop, and the loops of all active shards
# advance together with one blocking read a round (run_lockstep). Blocks
# are updated in place, as the local executor updates its dist.
# ---------------------------------------------------------------------------


_ROW_KEYS = ("qidx", "src", "lab", "dst", "start", "active")


def _shard_rows_np(btt: BatchedTransitionTable, q_cap: int, n_shards: int,
                   j_bucket: int = 8):
    """The rows of :func:`shard_transitions` as a dict of (n_shards, J_s)
    numpy arrays (one host read of the table)."""
    if q_cap % n_shards:
        raise ValueError(f"q_cap {q_cap} not divisible by {n_shards} shards")
    q_shard = q_cap // n_shards
    cols = device_get(torch.stack([btt.qidx, btt.src, btt.lab, btt.dst,
                                   btt.start_mask.long(), btt.active.long()]))
    qidx, src, lab, dst, start, active = cols
    owned = [[] for _ in range(n_shards)]
    for j in np.nonzero(active)[0].tolist():
        owned[int(qidx[j]) // q_shard].append(j)
    j_max = max([len(r) for r in owned] + [1])
    j_s = max(j_max + (-j_max) % j_bucket, j_bucket)
    out = {key: np.zeros((n_shards, j_s), np.int32) for key in _ROW_KEYS[:4]}
    out["start"] = np.zeros((n_shards, j_s), bool)
    out["active"] = np.zeros((n_shards, j_s), bool)
    for sh, ids in enumerate(owned):
        ids = np.asarray(ids, np.int64)
        r = len(ids)
        out["qidx"][sh, :r] = qidx[ids] - sh * q_shard
        out["src"][sh, :r] = src[ids]
        out["lab"][sh, :r] = lab[ids]
        out["dst"][sh, :r] = dst[ids]
        out["start"][sh, :r] = start[ids] != 0
        out["active"][sh, :r] = True
    return out


def shard_transitions(btt: BatchedTransitionTable, q_cap: int, n_shards: int,
                      j_bucket: int = 8, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Regroup a flattened transition table by lane shard, as the
    reference does: shard i owns lanes [i*q_cap/n_shards,
    (i+1)*q_cap/n_shards). Returns six (n_shards, J_s) tensors on
    ``device`` — qidx (SHARD-LOCAL lane index), src, lab, dst (int32),
    start_mask, active (bool) — with J_s the bucketed largest row count
    over shards (padding rows inert). ``q_cap`` must be a multiple of
    ``n_shards``."""
    dev = resolve_device(device)
    rows = _shard_rows_np(btt, q_cap, n_shards, j_bucket)
    return tuple(torch.as_tensor(rows[key]).to(dev) for key in _ROW_KEYS)


def _tables_from_rows(rows, k: int, n_labels: int, q_shard: int,
                      device: torch.device) -> List[BatchedTransitionTable]:
    """Per-shard tables on ``device`` from :func:`_shard_rows_np`'s rows."""
    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x)).to(device, dtype)

    return [BatchedTransitionTable(
        qidx=t(rows["qidx"][sh]), src=t(rows["src"][sh]),
        lab=t(rows["lab"][sh]), dst=t(rows["dst"][sh]),
        start_mask=t(rows["start"][sh], torch.bool),
        active=t(rows["active"][sh], torch.bool),
        start_idx=t(np.nonzero(rows["start"][sh])[0]),
        n_queries=q_shard, k=k, n_labels=n_labels)
        for sh in range(rows["qidx"].shape[0])]


def shard_tables(btt: BatchedTransitionTable, q_cap: int, n_shards: int,
                 j_bucket: int = 8, device: DeviceLike = None
                 ) -> List[BatchedTransitionTable]:
    """:func:`shard_transitions` as one :class:`BatchedTransitionTable` per
    shard (shard-local lanes, ``n_queries = q_cap / n_shards``), the form
    the shard rounds take."""
    rows = _shard_rows_np(btt, q_cap, n_shards, j_bucket)
    return _tables_from_rows(rows, btt.k, btt.n_labels, q_cap // n_shards,
                             resolve_device(device))


def _peer_cols(m: int, n_m: int) -> slice:
    return slice(m * n_m, (m + 1) * n_m)


# A shard round is three steps: each peer contracts its u block
# (peer_partial), the peers' partials fold with max (_fold_peers), and each
# peer takes the base term on its v columns and updates its block
# (peer_update). The frontier round has the same three. Given fewer blocks
# than its ``n_model`` peers, a round runs only those peers' shares, the
# missing peers' partials stood in by the first's in the fold: one device's
# share, which launch/dryrun_rpq.py times.


def peer_partial(blk: torch.Tensor, adj_u: torch.Tensor,
                 t: BatchedTransitionTable, backend: Backend) -> torch.Tensor:
    """Step 1 of a shard round on one model peer: the (J, N, N) partial of
    its (Q_l, N, N_m, K) block's gathered rows [x, u_m] against its u-row
    block ``adj_u`` (L, N_m, N) of each row's label (kernel B1, or B3 on
    the bucket backend, on the card)."""
    d_s = blk[t.qidx, :, :, t.src]                    # (J, N, N_m) [x, u_m]
    a_u = adj_u[t.lab]                                # (J, N_m, N) [u_m, v]
    return backend.contract_rows(d_s, a_u)


def _fold_peers(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Step 2, the reference's pmax: the peers' (J, M, N) partials folded
    with max into the first one, on its device, then each peer's v
    columns, on its own. A partial may appear more than once (the dry run
    stands one peer's in for the others')."""
    n_m = parts[0].shape[-1] // len(parts)
    full = parts[0]
    for p in parts[1:]:
        torch.maximum(full, p.to(full.device, non_blocking=True), out=full)
    return [full[..., _peer_cols(m, n_m)].to(p.device, non_blocking=True)
            for m, p in enumerate(parts)]


def peer_update(blk: torch.Tensor, adj_v: torch.Tensor,
                t: BatchedTransitionTable, backend: Backend,
                mask: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Step 3 of a shard round on one model peer: its folded (J, N, N_m)
    columns masked to the active rows of the lanes in ``mask``, the base
    term on the active start rows from its v-column block ``adj_v`` (L, N,
    N_m), the segment max into (lane, state) slices, and the max into
    ``blk`` in place. Returns the (Q_l,) lanes whose block changed."""
    q_l, k = blk.shape[0], blk.shape[3]
    active = t.active & mask.to(blk.device)[t.qidx]
    contrib.masked_fill_(~active[:, None, None], backend.zero)
    s = t.start_idx
    if s.numel():
        sub = contrib.index_select(0, s)
        base = adj_v[t.lab.index_select(0, s)]
        sub = torch.where(active.index_select(0, s)[:, None, None],
                          torch.maximum(sub, base), sub)
        contrib.index_copy_(0, s, sub)
        del sub, base
    upd = _segment_max(contrib, t.qidx * k + t.dst, q_l, k)
    changed = (upd > blk).reshape(q_l, -1).any(dim=1)
    torch.maximum(blk, upd, out=blk)
    return changed


def peer_frontier_partial(blk: torch.Tensor, adj_u: torch.Tensor,
                          t: BatchedTransitionTable, backend: Backend,
                          rows: torch.Tensor):
    """Step 1 of a frontier round on one model peer: gather its (Q_l, F,
    N_m, K) slab at the frontier ``rows`` (Q_l, F) and contract it against
    its u block. Returns ``(partial (J, F, N), slab, flat row ids)``."""
    q_l, n, n_m, k = blk.shape
    f = rows.shape[1]
    flat = (torch.arange(q_l, device=blk.device)[:, None] * n
            + rows.to(blk.device)).reshape(-1)
    slab = blk.view(q_l * n, -1).index_select(0, flat).view(q_l, f, n_m, k)
    slab_s = slab[t.qidx, :, :, t.src].contiguous()   # (J, F, N_m) [f, u_m]
    a_u = adj_u[t.lab]                                # (J, N_m, N)
    return backend.contract_rows(slab_s, a_u), slab, flat


def peer_frontier_update(blk: torch.Tensor, adj_v: torch.Tensor,
                         t: BatchedTransitionTable, backend: Backend,
                         rows: torch.Tensor, rowmask: torch.Tensor,
                         contrib: torch.Tensor, slab: torch.Tensor,
                         flat: torch.Tensor) -> torch.Tensor:
    """Step 3 of a frontier round on one model peer: the base term at the
    frontier rows of its v columns, the row mask, the segment max into its
    slab and the slab max-scattered back into ``blk`` in place. Returns
    the (Q_l, F) rows that changed."""
    q_l, n, _n_m, k = blk.shape
    f = rows.shape[1]
    rows_m, rm = rows.to(blk.device), rowmask.to(blk.device)
    rows_j = rows_m[t.qidx]                            # (J, F)
    a_base = adj_v[t.lab[:, None], rows_j]
    base_rows = t.start_mask & t.active
    contrib = torch.where(base_rows[:, None, None],
                          torch.maximum(contrib, a_base), contrib)
    act = t.active[:, None] & rm[t.qidx]               # (J, F)
    contrib.masked_fill_(~act[:, :, None], backend.zero)
    upd = _segment_max(contrib, t.qidx * k + t.dst, q_l, k)
    new_slab = torch.maximum(slab, upd)
    changed = (new_slab > slab).flatten(2).any(dim=2) & rm
    blk.view(q_l * n, -1).index_reduce_(
        0, flat, new_slab.reshape(q_l * f, -1), "amax", include_self=True)
    return changed


def _or_peers(flags: List[torch.Tensor]) -> torch.Tensor:
    """The peers' flags folded with OR onto the first peer's device."""
    out = flags[0]
    for f in flags[1:]:
        out = out | f.to(out.device, non_blocking=True)
    return out


def _shard_round(blocks: List[torch.Tensor], adj_u: List[torch.Tensor],
                 adj_v: List[torch.Tensor],
                 tables: List[BatchedTransitionTable], backend: Backend,
                 mask: torch.Tensor, n_model: int = 0) -> torch.Tensor:
    """One masked round of a lane shard (reference :1061-1119), in place
    on its peers' (Q_l, N, N_m, K) blocks in the backend's representation,
    with each peer's u-row and v-column adjacency blocks. Returns the
    (Q_l,) lanes that changed, on the first peer's device. One peer is the
    local round on the block. ``n_model`` (default: one peer a block)
    larger than the blocks given stands the missing peers in (above)."""
    n_model = n_model or len(blocks)
    if n_model == 1:
        return _relax_in_place(blocks[0], adj_u[0], tables[0], backend, mask)
    parts = [peer_partial(b, a, t, backend)
             for b, a, t in zip(blocks, adj_u, tables)]
    folded = _fold_peers(parts + parts[:1] * (n_model - len(parts)))
    changed = [peer_update(b, a, t, backend, mask, c)
               for b, a, t, c in zip(blocks, adj_v, tables, folded)]
    return mask & _or_peers(changed)


def _shard_frontier_round(blocks: List[torch.Tensor], adj_u: List[torch.Tensor],
                          adj_v: List[torch.Tensor],
                          tables: List[BatchedTransitionTable], backend: Backend,
                          rows: torch.Tensor, rowmask: torch.Tensor,
                          n_model: int = 0) -> torch.Tensor:
    """One frontier round of a lane shard (reference :1222-1262), in place
    on its peers' blocks: each peer gathers its (Q_l, F, N_m, K) slab and
    contracts its u block, and after the fold takes the base term at the
    frontier rows of its v columns and max-scatters its slab back.
    Returns the (Q_l, F) rows that changed (first peer's device). One
    peer is :func:`frontier_relax_round` on the block; ``n_model`` as in
    :func:`_shard_round`."""
    n_model = n_model or len(blocks)
    if n_model == 1:
        return frontier_relax_round(blocks[0], adj_u[0], tables[0], backend,
                                    rows, rowmask)[1]
    steps = [peer_frontier_partial(b, a, t, backend, rows)
             for b, a, t in zip(blocks, adj_u, tables)]
    parts = [s[0] for s in steps]
    folded = _fold_peers(parts + parts[:1] * (n_model - len(parts)))
    return _or_peers([
        peer_frontier_update(b, a, t, backend, rows, rowmask, c, slab, flat)
        for b, a, t, c, (_p, slab, flat)
        in zip(blocks, adj_v, tables, folded, steps)])


def _shard_dirty_rows(blocks: List[torch.Tensor], src: torch.Tensor,
                      smask: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(Q_l, N) dirty rows of a batch on one lane shard (reference
    :1263-1313; the cone of a delete on the pre-delete blocks): rows
    x = a batch source, and rows reaching one with a finite entry. Each
    peer gathers the columns of the batch sources in its own u range (the
    reference scans them; the mask is the same) and the peers' reach
    folds with OR. Computed on raw float32 timestamps."""
    dev = blocks[0].device
    if len(blocks) == 1:
        return frontier_seed_gathered(blocks[0], src.to(dev), smask.to(dev), mask)
    n, n_m = blocks[0].shape[1], blocks[0].shape[2]
    reach = []
    for m, blk in enumerate(blocks):
        local = src.to(blk.device) - m * n_m
        ok = smask.to(blk.device) & (local >= 0) & (local < n_m)
        cols = blk.index_select(2, torch.where(ok, local, 0))   # (Q_l, N, B, K)
        reach.append(((cols > NEG_INF) & ok[None, None, :, None])
                     .any(dim=3).any(dim=2))
        del cols
    dirty = _or_peers(reach) | _source_mask(src.to(dev), smask.to(dev), n)[None, :]
    return dirty & mask[:, None]


class Shard(NamedTuple):
    """One lane shard of a dispatch: its model peers' dist blocks, u-row
    (L, N_m, N) and v-column (L, N, N_m) adjacency blocks and transition
    tables (one each per peer, on the peer's device; with one peer both
    blocks are the whole adjacency), and its (Q_l,) query mask on the
    first peer's device with its host mirror (the skip decision reads the
    mirror, never the device)."""

    blocks: List[torch.Tensor]
    adj_u: List[torch.Tensor]
    adj_v: List[torch.Tensor]
    tables: List[BatchedTransitionTable]
    mask: torch.Tensor
    mask_host: np.ndarray


class _DenseLoop:
    """A shard's convergence-masked loop (reference ``_shard_dense_loop``),
    one round a step: round 1 relaxes the initial mask, each later round
    the lanes the previous one changed."""

    def __init__(self, ops, adjs, tables, backend, mask0, bound: int):
        self.ops, self.adjs, self.tables = ops, adjs, tables   # adjs: (u, v)
        self.backend, self.mask, self.bound = backend, mask0, bound
        self.query_rounds = mask0.to(torch.int32)
        self.rounds = 0

    def step(self) -> Optional[torch.Tensor]:
        """Run one round; returns the lanes left changing (a device
        scalar to read), or None once the bound is reached."""
        if self.rounds:
            self.query_rounds += self.mask
        self.mask = _shard_round(self.ops, *self.adjs, self.tables,
                                 self.backend, self.mask)
        self.rounds += 1
        return self.mask.sum() if self.rounds < self.bound else None

    def settle(self, left: int) -> bool:
        return left > 0


class _FrontierLoop:
    """A shard's frontier rounds (reference ``shard_frontier_closure``'s
    inner loop), one round a step: round 1 relaxes the seed rows, each
    later round the rows the previous one changed."""

    def __init__(self, ops, adjs, tables, backend, rows, rowmask0,
                 n_active: int, bound: int):
        self.ops, self.adjs, self.tables = ops, adjs, tables
        self.backend, self.rows, self.rm = backend, rows, rowmask0
        self.n_active, self.bound = n_active, bound
        self.query_rounds = torch.zeros((rowmask0.shape[0],), dtype=torch.int32,
                                        device=rowmask0.device)
        self.rounds = self.rows_relaxed = 0

    def step(self) -> Optional[torch.Tensor]:
        self.query_rounds += self.rm.any(dim=1).to(torch.int32)
        self.rm = _shard_frontier_round(self.ops, *self.adjs, self.tables,
                                        self.backend, self.rows, self.rm)
        self.rows_relaxed += self.n_active
        self.rounds += 1
        return self.rm.sum() if self.rounds < self.bound else None

    def settle(self, left: int) -> bool:
        self.n_active = left
        return left > 0


def run_lockstep(loops) -> int:
    """Advance the shards' loops together, a round at a time: every active
    loop enqueues its round, then ONE blocking read takes all their
    counts. Returns the number of reads."""
    active, reads = list(loops), 0
    while active:
        pending = [(lp, c) for lp, c in ((lp, lp.step()) for lp in active)
                   if c is not None]
        if not pending:
            break
        dev = pending[0][1].device
        left = device_get(torch.stack([c.to(dev) for _lp, c in pending]))  # repro: noqa[R1] one read a round for every shard's loop (lax.while_loop), counted in host_syncs
        reads += 1
        active = [lp for (lp, _c), v in zip(pending, left.tolist())
                  if lp.settle(int(v))]
    return reads


def _at(x: Optional[torch.Tensor], dev: torch.device):
    return None if x is None else x.to(dev)


class _Operands:
    """A dispatch's representation boundary: a shard's blocks encode when
    it runs (inside the reference's run branch), each distinct adjacency
    tensor once (views of one tensor through it: a device's u and v
    blocks share the whole slab's encoding), and results decode back to
    float32 timestamps."""

    def __init__(self, backend: Backend, now, w_max):
        self.backend, self.now, self.w_max = backend, now, w_max
        self._adj: dict = {}

    def _encode_adj(self, a: torch.Tensor) -> torch.Tensor:
        base = a._base
        if base is None or not base.is_contiguous() or base.storage_offset():
            base = a
        if id(base) not in self._adj:
            self._adj[id(base)] = (base, self.backend.prepare_state(
                None, base, _at(self.now, base.device),
                _at(self.w_max, base.device))[1])
        enc = self._adj[id(base)][1]
        if base is a:
            return enc
        # the encoding is elementwise into a contiguous tensor of the
        # base's shape, so the view's geometry carries over
        return enc.as_strided(a.size(), a.stride(), a.storage_offset())

    def encode(self, sh: Shard):
        be = self.backend
        ops = [be.prepare_state(b, None, _at(self.now, b.device),
                                _at(self.w_max, b.device))[0]
               for b in sh.blocks]
        return ops, ([self._encode_adj(a) for a in sh.adj_u],
                     [self._encode_adj(a) for a in sh.adj_v])

    def decode(self, ops) -> List[torch.Tensor]:
        return [self.backend.decode_state(d, _at(self.now, d.device),
                                          _at(self.w_max, d.device))
                for d in ops]


def shards_closure(shards: Sequence[Shard], backend: BackendLike = None,
                   max_rounds: int = 0, now=None, w_max=None):
    """Every shard's closure of one dispatch (reference ``shard_closure``
    per shard): a shard with no lane in its mask skips (no encode, no
    round, 0 rounds), the others iterate to their own fixpoints in
    lockstep. Returns ``([(blocks, rounds, query_rounds)] per shard,
    host_syncs)``; blocks are the results in float32 (the inputs, updated
    in place, for the float backends)."""
    backend = resolve_backend(backend)
    operands = _Operands(backend, now, w_max)
    loops: List[Optional[_DenseLoop]] = []
    for sh in shards:
        if not sh.mask_host.any():
            loops.append(None)
            continue
        n, k = sh.blocks[0].shape[1], sh.blocks[0].shape[3]
        ops, adjs = operands.encode(sh)
        loops.append(_DenseLoop(ops, adjs, sh.tables, backend, sh.mask,
                                max_rounds if max_rounds > 0 else n * k + 1))
    syncs = run_lockstep(lp for lp in loops if lp is not None)
    out = []
    for sh, lp in zip(shards, loops):
        if lp is None:
            out.append((sh.blocks, 0, torch.zeros_like(sh.mask, dtype=torch.int32)))
        else:
            out.append((operands.decode(lp.ops), lp.rounds, lp.query_rounds))
    return out, syncs


def shards_frontier(shards: Sequence[Shard], src: torch.Tensor,
                    smask: torch.Tensor, f_cap: int, backend: BackendLike = None,
                    max_rounds: int = 0, now=None, w_max=None,
                    delete: bool = False):
    """Every shard's frontier closure (``delete=False``, reference
    ``shard_frontier_closure``) or cone-seeded delete (``delete=True``,
    ``shard_frontier_delete``) of one dispatch. Each shard seeds its dirty
    rows; ONE host read takes every shard's per-lane counts. A shard with
    no dirty row skips; one whose lane overflows ``f_cap`` runs its own
    dense loop (a delete from all -inf), the others their frontier rounds
    (a delete clears its cone rows first), all in lockstep. Returns
    ``([(blocks, rounds, query_rounds, FrontierStats)] per shard,
    host_syncs)``."""
    backend = resolve_backend(backend)
    plans = []
    for sh in shards:
        dirty = _shard_dirty_rows(sh.blocks, src, smask, sh.mask)
        plans.append((dirty, *pack_frontier(dirty, f_cap)))
    home = shards[0].blocks[0].device
    cnt_h = device_get(torch.cat([p[3].to(home) for p in plans]))  # repro: noqa[R1] every shard's fallback decision (lax.cond), one read a dispatch, counted in host_syncs
    syncs = 1
    operands = _Operands(backend, now, w_max)
    loops, stats = [], []
    q0 = 0
    for sh, (dirty, rows, rowmask0, _cnt) in zip(shards, plans):
        q_l, n, _n_m, k = sh.blocks[0].shape
        c = cnt_h[q0:q0 + q_l]
        q0 += q_l
        overflow = bool((c > f_cap).any())
        stats.append((int(c.sum()), int(c.max()), overflow))
        if not (c > 0).any():
            loops.append(None)
            continue
        bound = max_rounds if max_rounds > 0 else n * k + 1
        if delete:
            for b in sh.blocks:
                if overflow:
                    b.fill_(NEG_INF)
                else:
                    b.masked_fill_(dirty.to(b.device)[:, :, None, None], NEG_INF)
        ops, adjs = operands.encode(sh)
        if overflow:
            loops.append(_DenseLoop(ops, adjs, sh.tables, backend, sh.mask, bound))
        else:
            loops.append(_FrontierLoop(ops, adjs, sh.tables, backend, rows,
                                       rowmask0, int(np.minimum(c, f_cap).sum()),
                                       bound))
    syncs += run_lockstep(lp for lp in loops if lp is not None)
    out = []
    for sh, lp, (seed, top, overflow) in zip(shards, loops, stats):
        if lp is None:
            out.append((sh.blocks, 0, torch.zeros_like(sh.mask, dtype=torch.int32),
                        FrontierStats(seed, top, 0, False)))
            continue
        relaxed = (lp.rounds * int(sh.mask_host.sum()) * sh.blocks[0].shape[1]
                   if overflow else lp.rows_relaxed)
        out.append((operands.decode(lp.ops), lp.rounds, lp.query_rounds,
                    FrontierStats(seed, top, relaxed, overflow)))
    return out, syncs


# The single-shard entry points, the reference's names and return values:
# ``blocks`` is a (Q_l, N, N_m, K) tensor or a list of the model peers'
# blocks, ``adjs`` the whole (L, N, N) adjacency (one, or one per peer),
# ``table`` the shard's BatchedTransitionTable (one, or one per peer).


def peer_views(adj: torch.Tensor, m: int, n_model: int):
    """Model peer m's (u-row, v-column) blocks of a whole (L, N, N)
    adjacency, as views; with one peer both are the adjacency."""
    if n_model == 1:
        return adj, adj
    cols = _peer_cols(m, adj.shape[1] // n_model)
    return adj[:, cols], adj[:, :, cols]


def _shard_of(blocks, adjs, table, query_mask) -> Shard:
    blocks = blocks if isinstance(blocks, list) else [blocks]
    adjs = adjs if isinstance(adjs, list) else [adjs] * len(blocks)
    tables = table if isinstance(table, list) else [table] * len(blocks)
    views = [peer_views(a, m, len(blocks)) for m, a in enumerate(adjs)]
    mask = torch.as_tensor(query_mask).to(blocks[0].device, torch.bool)
    return Shard(blocks, [u for u, _ in views], [v for _, v in views], tables,
                 mask, device_get(mask))


def _like(out: List[torch.Tensor], blocks):
    return out if isinstance(blocks, list) else out[0]


def shard_relax_round(blocks, adjs, table, query_mask,
                      backend: BackendLike = None):
    """One masked round of one lane shard on copies of its blocks
    (reference ``shard_relax_round``): returns ``(new_blocks, changed)``,
    changed (Q_l,) bool. Operands in the backend's representation."""
    sh = _shard_of(blocks, adjs, table, query_mask)
    new = [b.clone() for b in sh.blocks]
    changed = _shard_round(new, sh.adj_u, sh.adj_v, sh.tables,
                           resolve_backend(backend), sh.mask)
    return _like(new, blocks), changed


def shard_closure(blocks, adjs, table, query_mask, backend: BackendLike = None,
                  max_rounds: int = 0, now=None, w_max=None):
    """One lane shard's closure with convergence-aware dispatch (reference
    ``shard_closure``): skipped (0 rounds, blocks passed through) when no
    lane is in ``query_mask``. Returns ``(blocks, rounds, query_rounds)``."""
    (res, rounds, qrounds), = shards_closure(
        [_shard_of(blocks, adjs, table, query_mask)], backend, max_rounds,
        now, w_max)[0]
    return _like(res, blocks), rounds, qrounds


def _frontier_entry(delete, blocks, adjs, table, query_mask, src, smask, f_cap,
                    backend, max_rounds, now, w_max):
    (res, rounds, qrounds, st), = shards_frontier(
        [_shard_of(blocks, adjs, table, query_mask)], src, smask, f_cap,
        backend, max_rounds, now, w_max, delete)[0]
    return (_like(res, blocks), rounds, qrounds, st.rows_relaxed, st.fell_back,
            st.seed_rows, st.max_lane_rows)


def shard_frontier_closure(blocks, adjs, table, query_mask, src, smask,
                           f_cap: int, backend: BackendLike = None,
                           max_rounds: int = 0, now=None, w_max=None):
    """One lane shard's frontier ingest (reference
    ``shard_frontier_closure``). Returns ``(blocks, rounds, query_rounds,
    rows_relaxed, fell_back, seed_rows, max_lane_rows)``."""
    return _frontier_entry(False, blocks, adjs, table, query_mask, src, smask,
                           f_cap, backend, max_rounds, now, w_max)


def shard_frontier_delete(blocks, adjs, table, query_mask, src, smask,
                          f_cap: int, backend: BackendLike = None,
                          max_rounds: int = 0, now=None, w_max=None):
    """One lane shard's cone-seeded delete on its PRE-delete blocks and the
    RETAINED adjacency (reference ``shard_frontier_delete``); the same
    return value as :func:`shard_frontier_closure`."""
    return _frontier_entry(True, blocks, adjs, table, query_mask, src, smask,
                           f_cap, backend, max_rounds, now, w_max)
