"""Per-round capacity plan of the streaming-RPQ engine on the production
grid — the counterpart of ``repro.launch.dryrun_rpq``.

A closure's round count depends on the data, so a round is the unit
priced: one bottleneck relaxation round of the dense engine, per cell and
mode, on the production grid (:func:`~repro_torch.launch.mesh.
make_production_grid`: 16 x 16, or 2 x 16 x 16). The reference lowers the
whole-mesh program and reads XLA's cost and memory analyses. Here no
compiler sees the mesh, so each cell computes every device's block shapes,
allocates ONE device's blocks (device (0, 0)) from a ``torch.Generator``
seeded by ``--seed``, and executes that device's share of one round with
the port's kernels, timed with CUDA events:

    ring              :func:`ring_row` of its own data row's peer 0, the
                      row function of :func:`make_ring_round`: the local
                      partial of its u block (``contract_rows``: kernel
                      B1), then the (tp - 1)-hop max fold, the received
                      blocks stood in by -inf blocks
    baseline          :func:`relax_round_vchunked` on its v block after
                      the dist's u all-gather (B1, one launch a v chunk)
    mxu               the single-query round through ``BucketBackend`` on
                      int32 levels (B3, one launch)
    batched[-cuda]    the ``share_fn`` of the mesh executor's round
    batched-mxu_bucket  (``distributed.executor.batched_round_lowering``):
    batched-plain     one model peer's partial (B1; B3 on the bucket
                      backend), the peers' max fold with their partials
                      stood in by its own, its base term and update
    batched-frontier  the same at the (Q_l, F) frontier rows
                      (``frontier_round_lowering``): B1 on (F, N_m) slabs

Each share is the round's own code with the other devices' contributions
stood in; on a dist whose other peers' blocks hold no finite entry it
equals the round's block (0, 0), which the tests hold against the
reference's unsharded rounds.

Layouts, as the reference's: dist (x, u, s) x over (pod,)data and u over
model, the adjacency v over model (u over model for the ring); the
batched cells stack ``BATCHED_QUERIES`` with lanes over (pod,)data and v
over model.

The record keeps the reference's keys where they mean the same thing
(``state_bytes_per_chip``, ``semiring_ops``, ``frontier_cap``,
``n_levels``, ``level_dots``, the ``adjacency`` napkin, ``n_slots``, ``k``,
``n_labels``, ``query``, ``chips``, ``mesh``) and adds, from the run:
``device_ms`` (CUDA-event mean of the share over ``repeats`` calls after a
warm-up), ``peak_bytes_per_chip`` (``torch.cuda.max_memory_allocated``
after a reset, less what the process held before the cell: the blocks
and the share's temporaries), ``fits_hbm``
(against the card's own memory), ``launches`` (kernel launches of one
share, by kernel), ``bound_ms``/``bound_by`` (the larger of the share's
bytes, each operand read once and the new block written once, over 3.35
TB/s, the H100 SXM's HBM3, and its operations over the H100 SXM's
published peak for their type, as chip_smoke.py prices the kernels:
min/max operations, one min and one max per (j, i, k, n) of each
contraction plus the fold's maxes, over float32's 67 TFLOP/s; the level
modes' int8 operations, two per (j, i, k, n, threshold) with both levels
at or above it, over 1979 TOP/s),
``device`` (``nvidia-smi``'s name and power limit) and ``run_s`` (the
cell's wall seconds; the reference's ``compile_s``). On the CPU
(``--device cpu``, tests only) the same code runs the plain versions and
the device fields are None: not measured.

There is no HLO to scrape, so the collectives are a model of what the
layout implies per round and per device (``collective_wire_bytes_extrap``,
``collectives_by_kind_extrap``): the ring sends (tp - 1) hops of one
(x_l, u_l, K) block (``collective-permute``); baseline and mxu receive the
other peers' u blocks of their x rows, (tp - 1) x_l N_m K elements
(``all-gather``); the batched modes fold the (J_l, N, N) partials, or
(J_l, F, N) at the frontier, with max across the model peers, and as each
peer keeps only its own v columns the fold is a reduce-scatter, (tp - 1)
/ tp of one partial sent per device (``reduce-scatter``; the reference's
``pmax`` is an all-reduce, twice that). The peers' changed-flag OR
((Q_l,) booleans) is left out.

Records go to ``chiprun_out/dryrun_rpq/`` at the repo root (git-ignored),
one JSON file per cell, mode and grid, reused unless ``--force``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_rpq [--cell NAME]
        [--mesh pod|multipod|both] [--modes m1,m2] [--force]
        [--device cuda|cpu] [--seed S] [--repeats R]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.automaton import compile_query
from ..core.contraction import Backend, BucketBackend, PlainBackend, resolve_backend
from ..core.semiring import (
    NEG_INF,
    BatchedTransitionTable,
    TransitionTable,
    _shard_rows_np,
)
from ..device import DeviceLike, resolve_device
from ..distributed.executor import batched_round_lowering, frontier_round_lowering
from ..kernels.bucket import bucket as _b3
from ..kernels.maxmin import maxmin as _b1
from .mesh import make_production_grid

RESULTS_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun_rpq"

# engine cells: (name, n_slots, query, v-chunk), the reference's
RPQ_CELLS = [
    ("rpq_n4096_k2", 4096, "a . b*", 512),
    ("rpq_n8192_k3", 8192, "a . b* . c", 512),
    ("rpq_n16384_k2", 16384, "(a | b)*", 512),
]

N_LEVELS = 8  # |W|/beta buckets for the level modes (the reference's napkin)

F_CAP = 256   # frontier capacity of the "batched-frontier" cell: a device
              # contracts (J_l, F, N_m) slabs, O(J*F*N^2) over the grid

ELL_CAP_ANALYTIC = 8    # degree cap for the padded-ELL adjacency napkin
SPILL_CAP_ANALYTIC = 256  # replicated spill-ring slots (16 B each)

# the multi-query serving cell (mode "batched*"): the Table-2 workload
# stacked into one (Q, N, N, K) relaxation, the batched engine's round
BATCHED_QUERIES = ["a*", "a . b*", "a . b* . c*", "(a | b | c)*", "a . b* . c",
                   "a* . b*", "a . b . c*", "a? . b*"]

MODES = ("baseline", "mxu", "ring", "batched", "batched-frontier")

PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
PEAK_F32_OPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12   # H100 SXM, dense int8 on the tensor cores

# the stream clock the level modes quantize against: timestamps lie in
# [NOW - W_MAX, NOW), 8 levels over the window
NOW, W_MAX = 1000.0, 80.0


def _round_up(n: int, b: int) -> int:
    return -(-n // b) * b


# ---------------------------------------------------------------------------
# the single-query rounds over a device grid
# ---------------------------------------------------------------------------


def _ring_partial(dist_blk: torch.Tensor, adj_blk: torch.Tensor,
                  tt: TransitionTable, backend: Backend) -> torch.Tensor:
    """A device's local partial (reference ``make_ring_round.body``'s
    ``per_t`` loop): its (x_l, u_l, K) dist block against its (L, u_l, N)
    u-row adjacency block, every transition in one ``contract_rows`` call,
    each contribution max-folded into its destination state. (x_l, N, K)."""
    x_l, _u_l, k = dist_blk.shape
    n = adj_blk.shape[2]
    d_s = dist_blk.permute(2, 0, 1)[tt.src].contiguous()   # (J, x_l, u_l)
    contrib = backend.contract_rows(d_s, adj_blk[tt.lab])    # (J, x_l, N)
    part = torch.full((x_l, n, k), NEG_INF, dtype=dist_blk.dtype,
                      device=dist_blk.device)
    for j in range(tt.src.shape[0]):
        upd = torch.where(tt.dst_onehot[j][None, None, :] > 0,
                          contrib[j][:, :, None], NEG_INF)
        torch.maximum(part, upd, out=part)
    return part


def _take(part: torch.Tensor, block: int, tp: int) -> torch.Tensor:
    u_l = part.shape[1] // tp
    b = block % tp
    return part[:, b * u_l:(b + 1) * u_l]


def ring_row(blks: List[torch.Tensor], adj_blks: List[torch.Tensor],
             tt: TransitionTable, tp: int, backend=None) -> List[torch.Tensor]:
    """One data row of :func:`make_ring_round` over its first
    ``len(blks)`` model peers: each peer's (x_l, u_l, K) dist block and
    (L, u_l, N) u-row adjacency block (on its device) to its new block.
    Each peer contracts its local u block, then the partials ring around
    the row: after hop h peer m holds block m + h + 2 maxed over peers
    m .. m + h + 1, after tp - 1 hops its own block over all. Hops are
    ``.to(peer, non_blocking=True)`` copies followed by ``torch.maximum``,
    in the reference's order. With fewer than ``tp`` peers (one device's
    share: ``[device (0, 0)]``) the last peer given receives -inf blocks,
    what peers whose dist blocks hold no finite entry send."""
    backend = resolve_backend(backend)
    n = len(blks)
    parts = [_ring_partial(b, a, tt, backend) for b, a in zip(blks, adj_blks)]
    acc = [_take(p, m + 1, tp) for m, p in enumerate(parts)]
    silent = None if n == tp else torch.full_like(acc[-1], NEG_INF)
    for h in range(tp - 1):
        # ppermute (k -> k - 1): peer m receives peer m + 1's block
        acc = [(acc[(m + 1) % tp] if n == tp or m + 1 < n else silent)
               .to(b.device, non_blocking=True) for m, b in enumerate(blks)]
        acc = [torch.maximum(a, _take(p, m + h + 2, tp))
               for m, (a, p) in enumerate(zip(acc, parts))]
    return [torch.maximum(b, a) for b, a in zip(blks, acc)]


def make_ring_round(grid: List[List[torch.device]], tt: TransitionTable,
                    backend=None):
    """The ring reduce-scatter(max) round (reference ``make_ring_round``)
    over a device grid, repeats allowed: dist (N, N, K) x over the data
    rows and u over the model peers, the adjacency's u rows over the model
    peers, each row through :func:`ring_row`. The base term is applied
    outside the iterated round, as in the reference, so callers compare on
    a dist that already dominates it. ``round_fn(dist, adj) -> dist'`` on
    the grid's first device."""
    tp, n_data = len(grid[0]), len(grid)

    def round_fn(dist: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        n = dist.shape[0]
        x_l, u_l = n // n_data, n // tp
        rows_out = []
        for i, row in enumerate(grid):
            xs = slice(i * x_l, (i + 1) * x_l)
            cols = [slice(m * u_l, (m + 1) * u_l) for m in range(tp)]
            new = ring_row([dist[xs, c].to(dev) for c, dev in zip(cols, row)],
                           [adj[:, c].to(dev) for c, dev in zip(cols, row)],
                           tt, tp, backend)
            rows_out.append(torch.cat([b.to(dist.device) for b in new], dim=1))
        return torch.cat(rows_out, dim=0)

    return round_fn


def vchunked_share(d_rows: torch.Tensor, adj_v: torch.Tensor,
                   tt: TransitionTable, v_chunk: int, x0: int, v0: int,
                   backend=None) -> torch.Tensor:
    """One device's share of :func:`relax_round_vchunked`: its x rows
    ``d_rows`` (x_l, N, K) with every u (after the all-gather), its v-column
    adjacency block ``adj_v`` (L, N, N_m) for the v columns from ``v0``,
    its rows starting at ``x0``. Per v chunk one ``contract_rows`` call
    for every transition (kernel B1; B3 on the bucket backend), the base
    term adj[l, x, v] on start transitions, each contribution max-folded
    into its destination state. Returns its new (x_l, N_m, K) block."""
    backend = resolve_backend(backend)
    x_l, _n, _k = d_rows.shape
    n_m = adj_v.shape[2]
    out = d_rows[:, v0:v0 + n_m].clone()
    d_s = d_rows.permute(2, 0, 1)[tt.src].contiguous()      # (J, x_l, N)
    a_l = adj_v[tt.lab]                                       # (J, N, N_m)
    vc = min(v_chunk, n_m)
    for c in range(0, n_m, vc):
        contrib = backend.contract_rows(d_s, a_l[:, :, c:c + vc].contiguous())
        base = a_l[:, x0:x0 + x_l, c:c + vc]
        contrib = torch.where(tt.start_mask[:, None, None],
                              torch.maximum(contrib, base), contrib)
        for j in range(tt.src.shape[0]):
            upd = torch.where(tt.dst_onehot[j][None, None, :] > 0,
                              contrib[j][:, :, None], backend.zero)
            torch.maximum(out[:, c:c + vc], upd, out=out[:, c:c + vc])
    return out


def relax_round_vchunked(dist: torch.Tensor, adj: torch.Tensor,
                         tt: TransitionTable, v_chunk: int,
                         grid: Optional[List[List[torch.device]]] = None,
                         backend=None) -> torch.Tensor:
    """One relaxation round chunked over the output v axis (reference
    ``relax_round_vchunked``), over a device grid (None: one device, the
    unsharded round): dist (N, N, K) x over the data rows, the adjacency's
    v over the model peers; each device all-gathers its x rows' u axis and
    runs :func:`vchunked_share`. With the bucket backend on int32 levels
    this is the reference's ``mxu`` round."""
    grid = grid or [[dist.device]]
    n = dist.shape[0]
    x_l, n_m = n // len(grid), n // len(grid[0])
    rows_out = []
    for i, row in enumerate(grid):
        xs = slice(i * x_l, (i + 1) * x_l)
        rows_out.append(torch.cat([vchunked_share(
            dist[xs].to(dev), adj[:, :, m * n_m:(m + 1) * n_m].to(dev), tt,
            v_chunk, i * x_l, m * n_m, backend).to(dist.device)
            for m, dev in enumerate(row)], dim=1))
    return torch.cat(rows_out, dim=0)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _level_ops(a: torch.Tensor, b: torch.Tensor, t_levels: int) -> float:
    """int8 operations of a level product (J, M, K) x (J, K, N) on these
    levels: two per (j, i, k, n, threshold) with both at or above it."""
    pairs = 0.0
    for theta in range(1, t_levels + 1):
        pairs += float(((a >= theta).sum(1).double()
                        * (b >= theta).sum(2).double()).sum())
    return 2.0 * pairs


def _batched_table(device: DeviceLike = "cpu"):
    dfas = [compile_query(q) for q in BATCHED_QUERIES]
    labels = sorted(set().union(*[set(d.labels) for d in dfas]))
    return dfas, labels, BatchedTransitionTable.from_dfas(dfas, labels,
                                                          device=device)


def plan_cell(name: str, n_slots: int, query: str, v_chunk: int,
              multi_pod: bool, mode: str) -> Dict[str, Any]:
    """A cell's analytic record fields, from shapes alone (no device): the
    reference's keys, one device's ``block_shapes``, its transition rows
    ``j_local`` and the collective model's bytes (module docstring)."""
    shape, _axes = make_production_grid(multi_pod=multi_pod)
    chips = int(np.prod(shape))
    tp = shape[-1]
    n_x = chips // tp                    # the (pod,)data shards
    n_m = n_slots // tp
    # analytic metadata describes the program a cell runs: the batched
    # modes stack BATCHED_QUERIES, not the cell's single query
    dfa = compile_query(query)
    query_tag, meta_k, meta_labels = query, dfa.k, dfa.n_labels
    n_transitions = len(dfa.transitions())
    frontier = mode.endswith("frontier")
    levels = mode == "mxu" or mode.endswith("mxu_bucket")
    if mode.startswith("batched"):
        dfas, labels, btt = _batched_table()
        query_tag = f"batched[{len(dfas)}]: " + " ; ".join(BATCHED_QUERIES)
        meta_k, meta_labels = btt.k, len(labels)
        n_transitions = sum(len(d.transitions()) for d in dfas)
        q_cap = _round_up(len(dfas), n_x)
        q_l = q_cap // n_x
        j_local = int(_shard_rows_np(btt, q_cap, n_x)["qidx"].shape[1])
        dist_shape = (q_cap, n_slots, n_slots, btt.k)
        adj_shape = (btt.n_labels, n_slots, n_slots)
        blocks = {"dist": (q_l, n_slots, n_m, btt.k),
                  "adj_u": (btt.n_labels, n_m, n_slots),
                  "adj_v": (btt.n_labels, n_slots, n_m)}
        rows = min(F_CAP, n_slots) if frontier else n_slots
        if frontier:
            blocks["frows"] = blocks["rowmask"] = (q_l, rows)
        else:
            blocks["mask"] = (q_l,)
        wire = {"reduce-scatter": (tp - 1) / tp * j_local * rows * n_slots * 4.0}
    else:
        k = dfa.k
        j_local = max(n_transitions, 1)
        dist_shape = (n_slots, n_slots, k)
        adj_shape = (dfa.n_labels, n_slots, n_slots)
        x_l = n_slots // n_x
        if mode == "ring":
            u_l = n_slots // tp
            blocks = {"dist": (x_l, u_l, k), "adj": (dfa.n_labels, u_l, n_slots)}
            wire = {"collective-permute": (tp - 1) * x_l * u_l * k * 4.0}
        else:   # baseline | mxu: the x rows after the u all-gather
            blocks = {"dist_rows": (x_l, n_slots, k),
                      "adj_v": (dfa.n_labels, n_slots, n_m)}
            wire = {"all-gather": (tp - 1) * x_l * n_m * k * 4.0}
    return {
        "arch": f"{name}-{mode}", "shape": "ingest_round",
        "engine_mode": mode,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "kind": "rpq",
        "query": query_tag, "k": meta_k, "n_labels": meta_labels,
        "n_slots": n_slots, "v_chunk": v_chunk,
        "block_shapes": {key: list(v) for key, v in blocks.items()},
        "j_local": j_local,
        "state_bytes_per_chip": (float(np.prod(dist_shape)) * 4
                                 + float(np.prod(adj_shape)) * 4) / chips,
        "collective_wire_bytes_extrap": sum(wire.values()),
        "collectives_by_kind_extrap": wire,
        # semiring ops (max + min per MAC-equivalent) of the whole round:
        # the frontier round contracts an (F, N) slab per transition row,
        # O(F*N^2), instead of the dense (N, N) row block's O(N^3)
        "semiring_ops": (2.0 * n_transitions * min(F_CAP, n_slots) * n_slots**2
                         if frontier else 2.0 * n_transitions * n_slots**3),
        "frontier_cap": min(F_CAP, n_slots) if frontier else 0,
        # the level modes run n_levels + 1 thresholds (the extra level
        # absorbs the origin-snap slack)
        "n_levels": N_LEVELS if levels else 0,
        "level_dots": N_LEVELS + 1 if levels else 0,
        # adjacency-layout napkin: what the same cell's adjacency state and
        # base-term reads cost in the padded-ELL layout (int32 index +
        # float32 timestamp per slot, the replicated 16-byte spill ring)
        "adjacency": {
            "dense_bytes": 4.0 * meta_labels * n_slots**2,
            "ell_cap": ELL_CAP_ANALYTIC,
            "ell_bytes": (8.0 * meta_labels * n_slots * ELL_CAP_ANALYTIC
                          + 16.0 * SPILL_CAP_ANALYTIC),
            "ell_gather_ops": (2.0 * n_transitions * min(F_CAP, n_slots)
                               * ELL_CAP_ANALYTIC * n_slots),
        },
    }


class _Cell:
    """Device (0, 0)'s operands and share of a planned cell (see the
    module docstring): ``run()`` executes the share, ``plain()`` the same
    share with the plain versions."""

    def __init__(self, plan: Dict[str, Any], query: str,
                 dev: torch.device, gen: torch.Generator):
        mode = plan["engine_mode"]
        self.mode, self.dev, self.n = mode, dev, plan["n_slots"]
        self.shapes = {key: tuple(v) for key, v in plan["block_shapes"].items()}
        shape, _axes = make_production_grid(multi_pod=plan["mesh"] == "2x16x16")
        self.tp = shape[-1]
        self.n_m = self.n // self.tp
        levels = plan["level_dots"] > 0
        self.t_levels = plan["level_dots"]
        self.frontier = mode.endswith("frontier")

        def stamps(*size):
            """Timestamps in [NOW - W_MAX, NOW) (float32), every one finite."""
            return (NOW - W_MAX) + W_MAX * torch.rand(size, generator=gen,
                                                      device=dev)

        def lv(*size):
            return torch.randint(0, self.t_levels + 1, size, generator=gen,
                                 device=dev, dtype=torch.int32)

        if mode.startswith("batched"):
            suffix = mode.split("-", 1)[1] if "-" in mode else "cuda"
            _dfas, _labels, btt = _batched_table(dev)
            n_x = plan["chips"] // self.tp
            q_cap = _round_up(len(BATCHED_QUERIES), n_x)
            grid = [[dev] * self.tp for _ in range(n_x)]
            if self.frontier:
                self.backend = resolve_backend(None)
            else:
                self.backend = (BucketBackend(N_LEVELS) if suffix == "mxu_bucket"
                                else resolve_backend(suffix))

            def lower(backend):
                if self.frontier:
                    return frontier_round_lowering(grid, btt, q_cap, self.n,
                                                   self.shapes["frows"][1],
                                                   backend)
                return batched_round_lowering(grid, btt, q_cap, self.n, backend)

            self.lower = lower
            low = lower(self.backend)
            if low.block_shapes != self.shapes:
                raise AssertionError(f"{low.block_shapes} != {self.shapes}")
            self.share_fns = {self.backend: low.share_fn}
            self.table = low.tables[0][0]
            self.blk = stamps(*self.shapes["dist"])
            self.adj_u = stamps(*self.shapes["adj_u"])
            # peer 0's v block agrees with its u block where they overlap
            self.adj_v = stamps(*self.shapes["adj_v"])
            self.adj_v[:, :self.n_m] = self.adj_u[:, :, :self.n_m]
            if self.frontier:
                q_l, f = self.shapes["frows"]
                perm = torch.argsort(torch.rand((q_l, self.n), generator=gen,
                                                device=dev), dim=1)
                self.frows = perm[:, :f].sort(dim=1).values
                self.rowmask = torch.ones((q_l, f), dtype=torch.bool)
            else:
                self.mask = torch.ones(self.shapes["mask"], dtype=torch.bool)
            self.now = torch.tensor(NOW, device=dev)
            self.w_max = torch.tensor(W_MAX, device=dev)
            self.j = self.table.qidx.shape[0]
            self.k = self.shapes["dist"][3]
        else:
            self.tt = TransitionTable.from_dfa(compile_query(query), device=dev)
            self.v_chunk, self.k = plan["v_chunk"], self.tt.k
            self.j = self.tt.src.shape[0]
            self.backend = (BucketBackend(N_LEVELS) if levels
                            else resolve_backend(None))
            make = lv if levels else stamps
            if mode == "ring":
                self.dist = stamps(*self.shapes["dist"])
                self.adj = stamps(*self.shapes["adj"])
            else:
                self.dist = make(*self.shapes["dist_rows"])
                self.adj = make(*self.shapes["adj_v"])
            self.x_l = self.dist.shape[0]
        self.plain_backend = (BucketBackend(N_LEVELS, use_kernels=False)
                              if isinstance(self.backend, BucketBackend)
                              else PlainBackend())
        if self.j != plan["j_local"]:
            raise AssertionError(f"J {self.j} != the plan's {plan['j_local']}")

    def _share(self, backend):
        if self.mode == "ring":
            return ring_row([self.dist], [self.adj], self.tt, self.tp,
                            backend)[0]
        if self.mode in ("baseline", "mxu"):
            chunk = self.v_chunk if self.mode == "baseline" else self.n_m
            return vchunked_share(self.dist, self.adj, self.tt, chunk, 0, 0,
                                  backend)
        if backend not in self.share_fns:
            self.share_fns[backend] = self.lower(backend).share_fn
        rows = (self.frows, self.rowmask) if self.frontier else (self.mask,)
        return self.share_fns[backend](self.blk, self.adj_u, self.adj_v, *rows,
                                       now=self.now, w_max=self.w_max)

    def run(self) -> torch.Tensor:
        return self._share(self.backend)

    def plain(self) -> torch.Tensor:
        return self._share(self.plain_backend)

    def expected_launches(self) -> Dict[str, int]:
        """Kernel launches of one share on the card."""
        if isinstance(self.backend, BucketBackend):
            return {"B1": 0, "B3": 1}
        if self.backend.name != "cuda":
            return {"B1": 0, "B3": 0}
        if self.mode == "baseline":
            return {"B1": -(-self.n_m // min(self.v_chunk, self.n_m)), "B3": 0}
        return {"B1": 1, "B3": 0}

    def _operands(self) -> List[torch.Tensor]:
        if self.mode.startswith("batched"):
            out = [self.blk, self.adj_u, self.adj_v]
            return out + ([self.frows] if self.frontier else [])
        return [self.dist, self.adj]

    def bound(self) -> Tuple[float, str, float]:
        """(bound_ms, bound_by, operations) of the share on this data: its
        operands read once and its block written once over the HBM rate,
        against its min/max operations over the measured min/max rate plus
        a level product's int8 operations over the int8 peak."""
        tp, n, n_m, j, k = self.tp, self.n, self.n_m, self.j, self.k
        dots = 0.0
        if self.mode == "ring":
            x_l, u_l = self.dist.shape[0], self.dist.shape[1]
            out_numel = self.dist.numel()
            minmax = 2.0 * j * x_l * u_l * n + (tp - 1) * x_l * u_l * k
        elif self.mode in ("baseline", "mxu"):
            out_numel = self.x_l * n_m * k
            if self.mode == "mxu":
                d_s = self.dist.permute(2, 0, 1)[self.tt.src]
                dots, minmax = _level_ops(d_s, self.adj[self.tt.lab],
                                          self.t_levels), 0.0
            else:
                minmax = 2.0 * j * self.x_l * n * n_m
        else:
            t = self.table
            out_numel = self.blk.numel()
            rows = self.frows.shape[1] if self.frontier else n
            minmax = (tp - 1) * j * rows * n          # the fold's maxes
            if self.t_levels:
                now = torch.tensor(NOW, device=self.dev)
                w = torch.tensor(W_MAX, device=self.dev)
                enc = self.backend.encode
                d_s = enc(self.blk, now, w)[t.qidx, :, :, t.src]
                dots = _level_ops(d_s, enc(self.adj_u, now, w)[t.lab],
                                  self.t_levels)
            else:
                minmax += 2.0 * j * rows * n_m * n
        n_bytes = (sum(x.numel() * x.element_size() for x in self._operands())
                   + 4 * out_numel)
        t_bytes = n_bytes / PEAK_BYTES
        t_ops = minmax / PEAK_F32_OPS + dots / PEAK_INT8_OPS
        return (max(t_bytes, t_ops) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes", minmax + dots)


def _event_ms(fn, repeats: int) -> float:
    """CUDA-event mean of ``fn`` over ``repeats`` back-to-back calls on
    the current device, from an idle device."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def _time_ms(fn, dev: torch.device, repeats: int) -> Optional[float]:
    """:func:`_event_ms` of ``fn`` after one warm-up call; None off the
    card (not measured)."""
    fn()
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return _event_ms(fn, repeats)


def run_rpq_cell(name: str, n_slots: int, query: str, v_chunk: int,
                 multi_pod: bool, force: bool = False, mode: str = "baseline",
                 device: DeviceLike = None, seed: int = 0, repeats: int = 3,
                 check_plain: bool = False,
                 results_dir: Optional[Path] = None) -> Dict[str, Any]:
    """One cell's record: :func:`plan_cell`'s fields and the run's (cached
    as JSON under ``results_dir``, reused unless ``force``). ``device=None``
    means the card and raises without one. ``check_plain`` also runs the
    share with the plain versions on the same operands and records whether
    the two are equal (``plain_equal``, ``max_abs_err``) and the plain
    share's time (``plain_ms``)."""
    results_dir = Path(results_dir or RESULTS_DIR)
    mesh_tag = "multipod" if multi_pod else "pod"
    path = results_dir / f"{name}-{mode}__ingest_round__{mesh_tag}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    result = plan_cell(name, n_slots, query, v_chunk, multi_pod, mode)
    t0 = time.monotonic()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cell = _Cell(result, query, dev, gen)
    b1_0, b3_0 = _b1.maxmin_matmul_fused.launches, _b3.bucket_maxmin_fused.launches
    out = cell.run()
    launches = {"B1": _b1.maxmin_matmul_fused.launches - b1_0,
                "B3": _b3.bucket_maxmin_fused.launches - b3_0}
    device_ms = _time_ms(cell.run, dev, repeats)
    peak = torch.cuda.max_memory_allocated(dev) - held if on_card else None
    bound_ms, bound_by, ops = cell.bound()
    result.update({
        "ok": True,
        "device": _smi() if on_card else str(dev),
        "device_ms": device_ms,
        "repeats": repeats,
        "launches": launches,
        "expected_launches": cell.expected_launches(),
        "share_ops": ops,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "peak_bytes_per_chip": peak,
        "fits_hbm": (bool(peak <= torch.cuda.get_device_properties(dev).total_memory)
                     if on_card else None),
    })
    if check_plain:
        ref = cell.plain()
        result["plain_equal"] = bool(torch.equal(out, ref))
        diff = torch.where(out == ref, 0.0, (out.float() - ref.float()).abs())
        result["max_abs_err"] = float(diff.max())   # -inf == -inf is no error
        result["plain_ms"] = _time_ms(cell.plain, dev, 1)
    result["run_s"] = round(time.monotonic() - t0, 3)
    del cell, out
    results_dir.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="", help="one of RPQ_CELLS (default: all)")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the card (default; raises without one) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    for (name, n, q, vc) in RPQ_CELLS:
        if args.cell and args.cell != name:
            continue
        for mp in meshes:
            for mode in args.modes.split(","):
                r = run_rpq_cell(name, n, q, vc, mp, force=args.force, mode=mode,
                                 device=dev, seed=args.seed,
                                 repeats=args.repeats)
                print(f"[ok] {name}/{mode} x {r['mesh']}: device_ms "
                      f"{r['device_ms']}, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), peak {r['peak_bytes_per_chip']} B, "
                      f"wire {r['collective_wire_bytes_extrap'] / 2**20:.3f} "
                      f"MiB/round; {r['device']}", flush=True)


if __name__ == "__main__":
    main()
