"""(max, min) bottleneck-semiring relaxation over the product graph, for a
batch of queries — the dense layout of ``repro.core.semiring``
(lines 184-406).

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
made so the executor can count host syncs per dispatch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .contraction import Backend, BackendLike, resolve_backend

NEG_INF = float("-inf")


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
    contrib = backend.contract_batched(dist, adj, btt, active)   # (J, N, N)
    # base term: seed (x, x, s0) = +inf => min(+inf, adj[l, x, v]) = adj,
    # applied only to ACTIVE start rows so it cannot unmask a zeroed row
    s = btt.start_idx
    if s.numel():
        sub = contrib.index_select(0, s)
        base = adj.index_select(0, btt.lab.index_select(0, s))
        sub = torch.where(active.index_select(0, s)[:, None, None],
                          torch.maximum(sub, base), sub)
        contrib.index_copy_(0, s, sub)
        del sub, base
    # segment max over qidx * K + dst; empty segments stay -inf, the
    # semiring zero (jax.ops.segment_max fills the dtype minimum, which
    # is -inf for floats: the same values)
    seg = btt.qidx * k + btt.dst
    scat = torch.full((q * k, n, n), NEG_INF, dtype=dist.dtype,
                      device=dist.device)
    scat.index_reduce_(0, seg, contrib, "amax", include_self=True)
    return scat.view(q, k, n, n).permute(0, 2, 3, 1)


def batched_relax_round(
    dist: torch.Tensor,          # (Q, N, N, K)
    adj: torch.Tensor,           # (L, N, N) shared adjacency
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
        if not bool(changed.any()) or rounds >= bound:
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
    """:func:`batched_closure` plus the host-sync count."""
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
    is (Q,) (per-query window thresholds applied at read time; strict >)."""
    best = dist.masked_fill(~finals[:, None, None, :], NEG_INF).amax(dim=3)
    return best > low[:, None, None]
