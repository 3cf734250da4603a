"""Dense streaming RPQ engine, multi-query batched — the counterpart of
``repro.core.engine`` for the local and the mesh executor: the dense or
the padded-ELL adjacency, the dense or the row-sparse dist, and the
frontier-restricted ingest and deletion.

Q persistent queries share ONE adjacency over the union label alphabet and
step as one dispatch per micro-batch; the query set is live (queries
register and deregister while the stream flows). The engine is pure
orchestration — vertex interning, query lifecycle, result decoding, state
export — and everything device-facing lives behind the executor
(:mod:`repro_torch.core.executor`):

    stream -> service -> engine -> executor -> semiring rounds -> kernels
    (B1 over a dense adjacency, B5 over an ELL one; B6 gathers the
    row-sparse dist's frontier rows)

State (torch tensors on the executor's device; capacities grow at
runtime, append-only):
    adj     (L, N, N)    f32   newest edge timestamp per (label, u, v)
                               (or its padded-ELL form, sparse_adj.py)
    dist    (Q, N, N, K) f32   per-query bottleneck closure D[q, x, v, s]
                               (or its row-sparse form, sparse_dist.py)
    emitted (Q, N, N)    bool  pairs already reported per query
    now     ()           f32   stream clock (every event advances it)

The semantics are the JAX engine's, event for event: B = 1 matches the
paper tuple for tuple; B > 1 evaluates at batch boundaries; window expiry
is a read-time threshold, and slide-boundary expiry recycles vertex slots
at the group's largest window. The tests hold the two engines' per-event
results and invalidations equal.
"""
from __future__ import annotations

import collections
import math
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, device_get, device_put
from .automaton import DFA
from .executor import (
    BatchedEngineArrays,
    Executor,
    LocalExecutor,
    QueryTables,
    check_options,
    init_batched_arrays,
)
from .semiring import NEG_INF, BatchedTransitionTable, TransitionTable

Pair = Tuple[object, object]

Q_BUCKET = 4        # lane-capacity growth quantum
LABEL_BUCKET = 4    # label-axis rounding (absorbs small alphabet growth)


def _round_up(n: int, b: int) -> int:
    return max(n + (-n) % b, b)


# a lane with no registered query: empty language, no transitions, k=1
_INERT_DFA = DFA(
    labels=(),
    delta=np.full((1, 0), -1, np.int32),
    start=0,
    finals=frozenset(),
)


class EngineArrays(NamedTuple):
    """Single-query view — the Q=1 slice of the batched state, the public
    surface of :class:`DenseRPQEngine`."""

    adj: torch.Tensor      # (L, N, N) f32
    dist: torch.Tensor     # (N, N, K) f32
    emitted: torch.Tensor  # (N, N) bool
    now: torch.Tensor      # () f32


def init_arrays(n_slots: int, n_labels: int, k: int,
                device: DeviceLike = None) -> EngineArrays:
    """Empty single-query state (the Q=1 slice of the batched one)."""
    b = init_batched_arrays(n_slots, n_labels, 1, k, device)
    return EngineArrays(b.adj, b.dist[0], b.emitted[0], b.now)


def _host(x) -> np.ndarray:
    """A state leaf (tensor or array) as a host array."""
    return device_get(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _conflict_possible(
    dist: torch.Tensor,           # (Q, N, N, K)
    not_contained: torch.Tensor,  # (Q, K, K), 1 where [s] !>= [t]
    low: torch.Tensor,            # (Q,)
) -> torch.Tensor:
    """Over-approximate RSPQ conflict detection (Definition 16), per query:
    some root reaches some vertex v in states s and t with [s] ⊉ [t].
    Ancestorship is over-approximated by co-reachability (sound: never
    misses a conflict).

    The JAX version counts ``einsum("qxvs,qst,qxvt->q", p, m, p) > 0``
    over 0/1 operands; the count is positive exactly when some (x, v, s, t)
    has all three factors 1, which is what the boolean reduction here
    tests, with no floating-point product (on the card the einsum ran as
    a batched GEMV that took longer than the closure round)."""
    p = dist > low[:, None, None, None]                      # (Q, N, N, K)
    nc = not_contained.to(torch.bool)                        # (Q, K, K)
    hit = torch.zeros((p.shape[0],), dtype=torch.bool, device=p.device)
    for s in range(p.shape[3]):
        # reached in s, and in some t with [s] ⊉ [t]
        other = (p & nc[:, None, None, s, :]).any(dim=3)    # (Q, N, N)
        hit |= (p[..., s] & other).flatten(1).any(dim=1)
    return hit


class RegisteredQuery(NamedTuple):
    """One persistent query of a batched group."""

    name: str
    dfa: DFA
    window: float
    path_semantics: str = "arbitrary"  # arbitrary | simple


class PendingResults:
    """Deferred result decoding for one :meth:`insert_batch_pending` call.

    The device->host transfer of the emit matrix happens at
    :meth:`resolve` time, so the service can dispatch the next
    micro-batch before pulling this one's results. Each chunk snapshots
    the vertex interner; handles resolve in dispatch order (FIFO through
    the engine), and the engine drains them before any lane-set change."""

    def __init__(self, engine: "BatchedDenseRPQEngine", q_cap: int):
        self._engine = engine
        self._chunks: List[Tuple[torch.Tensor, List[Optional[object]], float]] = []
        self._fresh: List[Set[Pair]] = [set() for _ in range(q_cap)]
        self._decoded = False

    def _add(self, new_dev, vertex_of: List[Optional[object]], t: float) -> None:
        self._chunks.append((new_dev, vertex_of, t))

    def _decode_chunks(self) -> None:
        for new_dev, vertex_of, t in self._chunks:
            self._engine._decode_new_into(new_dev, vertex_of, t, self._fresh)
        self._chunks.clear()
        self._decoded = True

    def resolve(self) -> List[Set[Pair]]:
        """Per-lane NEW result pairs (idempotent; forces the host sync)."""
        if not self._decoded:
            self._engine._drain_pending(upto=self)
        return self._fresh


def _nonzero(mat: torch.Tensor) -> np.ndarray:
    """Row-major indices of the True entries (as ``np.nonzero`` stacked),
    found on the device so that only the indices cross to the host: two
    reads, the count and the copy, one span ``sync.decode``."""
    return device_get(mat, "decode", torch.nonzero)


class BatchedDenseRPQEngine:
    """Q persistent RPQs over ONE stream, stepped as one dispatch per
    micro-batch (see the module docstring). Lanes may hold ``None`` holes
    (inert padding) that the next :meth:`register_query` reclaims;
    per-lane accessors are indexed by lane, :meth:`lane_of` maps a query
    name to its lane.

    ``device=None`` runs on the CUDA card (and raises without one);
    ``backend=None`` is the kernel backend (B1 on a dense adjacency, B5 on
    an ELL one, B6 for the row-sparse frontier gather); ``"mxu_bucket"``
    or a ``BucketBackend`` runs the level-quantized closure (B3, or B5 on
    int32 levels, with a coarsened expiry). ``frontier``
    ("off" | "on" | "auto"), ``adj_layout`` ("dense" | "ell") and
    ``dist_layout`` ("dense" | "row_sparse", with ``dist_cap``) configure
    the default executor as in the JAX package."""

    def __init__(
        self,
        queries: Sequence[RegisteredQuery],
        n_slots: int = 128,
        batch_size: int = 32,
        backend=None,
        executor: Optional[Executor] = None,
        frontier: str = "off",
        frontier_cap: int = 32,
        adj_layout: str = "dense",
        ell_cap: int = 8,
        dist_layout: str = "dense",
        dist_cap: int = 16,
        device: DeviceLike = None,
    ):
        queries = list(queries)
        if not queries:
            raise ValueError("register at least one query")
        for q in queries:
            if q.dfa.containment is None:
                raise ValueError(f"compile query {q.name!r} with compile_query()")
        names = [q.name for q in queries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate query names: {names}")
        check_options(frontier=frontier, adj_layout=adj_layout,
                      dist_layout=dist_layout)
        # frontier and layout kwargs configure the default executor only;
        # an explicit executor instance arrives already configured
        self.executor = executor if executor is not None else LocalExecutor(
            backend, frontier=frontier, frontier_cap=frontier_cap,
            adj_layout=adj_layout, ell_cap=ell_cap, dist_layout=dist_layout,
            dist_cap=dist_cap, device=device)
        self.device = self.executor.device
        self.backend = self.executor.backend
        self.lane_specs: List[Optional[RegisteredQuery]] = list(queries)
        pad = _round_up(len(queries), self.executor.q_multiple) - len(queries)
        self.lane_specs.extend([None] * pad)
        self.n_slots = _round_up(n_slots, self.executor.n_multiple)
        self.batch_size = batch_size
        # shared alphabet: sorted at construction, new labels APPEND
        self.labels: Tuple[str, ...] = tuple(
            sorted(set().union(*[set(q.dfa.labels) for q in queries]))
        )
        self._label_index = {lab: i for i, lab in enumerate(self.labels)}
        self.k = 0
        self.max_window = 0.0
        self._rebuild_tables()
        n_label_slots = _round_up(len(self.labels), LABEL_BUCKET)
        self.executor.init_state(self.n_slots, n_label_slots, self.q_cap, self.k)
        # host mirror of the device stream clock
        self._host_now = NEG_INF
        self.slot_of: Dict[object, int] = {}
        self.vertex_of: List[Optional[object]] = [None] * self.n_slots
        self.free: List[int] = list(range(self.n_slots - 1, -1, -1))
        # slots referenced by the chunk being packed: a compaction
        # triggered mid-chunk must not recycle them
        self._chunk_pinned: Set[int] = set()
        self._pending_fifo: Deque[PendingResults] = collections.deque()
        #: blocking device->host reads the engine makes: one per decoded
        #: result matrix and one per conflict probe
        self.host_reads = 0
        self.per_query_results: List[Set[Pair]] = [set() for _ in range(self.q_cap)]
        self.per_query_log: List[List[Tuple[float, Pair]]] = [[] for _ in range(self.q_cap)]
        self.per_query_conflicted: List[bool] = [False] * self.q_cap

    # -- executor-backed accounting ------------------------------------------

    @property
    def batched_arrays(self) -> BatchedEngineArrays:
        return self.executor.arrays

    @property
    def host_now(self) -> float:
        """Host mirror of the device stream clock."""
        return self._host_now

    @property
    def total_rounds(self) -> int:
        return self.executor.rounds_total

    @property
    def total_query_rounds(self) -> int:
        return self.executor.query_rounds_total

    @property
    def steps(self) -> int:
        return self.executor.steps

    @property
    def host_syncs(self) -> int:
        """Blocking device->host reads: the closure loop's per-round flag
        reads (executor) plus the engine's result decodes and conflict
        probes."""
        return self.executor.host_syncs + self.host_reads

    # -- lane bookkeeping ----------------------------------------------------

    @property
    def q_cap(self) -> int:
        return len(self.lane_specs)

    @property
    def n_queries(self) -> int:
        return sum(1 for s in self.lane_specs if s is not None)

    @property
    def query_specs(self) -> List[RegisteredQuery]:
        return [s for s in self.lane_specs if s is not None]

    def live_items(self) -> List[Tuple[int, RegisteredQuery]]:
        return [(qi, s) for qi, s in enumerate(self.lane_specs) if s is not None]

    def lane_of(self, name: str) -> int:
        for qi, s in enumerate(self.lane_specs):
            if s is not None and s.name == name:
                return qi
        raise KeyError(f"no live query named {name!r}")

    def _rebuild_tables(self) -> None:
        """Recompute the flattened transition table and per-lane metadata
        from the lane list. K and max_window never shrink. The span
        ``engine.tables``; each upload is ``sync.tables``."""
        t0 = obs.on and obs.now()
        dfas = [s.dfa if s is not None else _INERT_DFA for s in self.lane_specs]
        self.btt = BatchedTransitionTable.from_dfas(
            dfas, self.labels, k_min=self.k, device=self.device)
        self.k = self.btt.k
        qc = self.q_cap
        fm = np.zeros((qc, self.k), bool)
        nc = np.zeros((qc, self.k, self.k), bool)
        self._simple = np.zeros((qc,), bool)
        self._check_conflict = np.zeros((qc,), bool)
        windows = np.zeros((qc,), np.float32)
        live = np.zeros((qc,), bool)
        for qi, spec in enumerate(self.lane_specs):
            if spec is None:
                continue
            dfa = spec.dfa
            for f in dfa.finals:
                fm[qi, f] = True
            nc[qi, : dfa.k, : dfa.k] = ~dfa.containment
            windows[qi] = spec.window
            self._simple[qi] = spec.path_semantics == "simple"
            self._check_conflict[qi] = (
                spec.path_semantics == "simple" and not dfa.has_containment_property
            )
            live[qi] = True
        self._windows_np = windows

        def put(x):
            return device_put(x, self.device, "tables")

        self.finals_mask = put(fm)
        self.not_contained = put(nc)
        self.windows = put(windows)
        self.live_mask = put(live)
        if live.any():
            self.max_window = float(windows[live].max())
        self.tables = QueryTables(
            self.btt, self.finals_mask, self.windows, self.live_mask,
            int(live.sum()), float(self.max_window), live,
        )
        if t0:
            obs.add("engine.tables", t0)

    def _repad_arrays(self) -> None:
        self.executor.grow(
            q_cap=self.q_cap,
            k=self.k,
            n_label_slots=_round_up(len(self.labels), LABEL_BUCKET),
        )

    def _conflict_flags(self) -> np.ndarray:
        """(Q,) host flags of the conflict probe, computed for the lanes
        that need it (the probe is per lane, so the others cannot change
        their answer)."""
        lanes = np.nonzero(self._check_conflict)[0]
        flags = np.zeros((self.q_cap,), bool)
        if lanes.size == 0:
            return flags
        t0 = obs.on and obs.now()
        self.host_reads += 1
        sel = device_put(lanes, self.device, "probe_lanes", torch.int64)
        low = self.executor.now - self.windows.index_select(0, sel)
        flags[lanes] = device_get(_conflict_possible(
            self.executor.lane_dist(lanes),
            self.not_contained.index_select(0, sel), low), "probe")
        if t0:
            obs.add("engine.probe", t0)
        return flags

    # -- query lifecycle -----------------------------------------------------

    def register_query(self, spec: RegisteredQuery) -> Set[Pair]:
        """Add a persistent query to the live group (works mid-stream):
        re-pad device state, seed the new lane with one closure pass over
        the existing adjacency, and return (and record as emitted) its
        initial result pairs."""
        if spec.dfa.containment is None:
            raise ValueError(f"compile query {spec.name!r} with compile_query()")
        if any(s is not None and s.name == spec.name for s in self.lane_specs):
            raise ValueError(f"query {spec.name!r} already registered")
        self._drain_pending()
        for lab in sorted(spec.dfa.labels):
            if lab not in self._label_index:
                self._label_index[lab] = len(self.labels)
                self.labels = self.labels + (lab,)
        lane = next((i for i, s in enumerate(self.lane_specs) if s is None), None)
        if lane is None:
            lane = len(self.lane_specs)
            q_quantum = Q_BUCKET * self.executor.q_multiple // math.gcd(
                Q_BUCKET, self.executor.q_multiple)
            new_cap = _round_up(lane + 1, q_quantum)
            grow = new_cap - lane
            self.lane_specs.extend([None] * grow)
            self.per_query_results.extend(set() for _ in range(grow))
            self.per_query_log.extend([] for _ in range(grow))
            self.per_query_conflicted.extend([False] * grow)
        self.lane_specs[lane] = spec
        self._rebuild_tables()
        self._repad_arrays()
        self.executor.clear_lane(lane)
        self.per_query_results[lane] = set()
        self.per_query_log[lane] = []
        self.per_query_conflicted[lane] = False
        if not self.slot_of:
            return set()  # nothing ingested yet: nothing to seed
        lane_mask = np.zeros((self.q_cap,), bool)
        lane_mask[lane] = True
        self.executor.relax(self.tables, query_mask=lane_mask)
        valid = self.executor.emit(self.tables)
        self.executor.set_lane_emitted(lane, valid[lane])
        if self._check_conflict[lane] and self._conflict_flags()[lane]:
            self.per_query_conflicted[lane] = True
        initial = self._decode_pairs(valid[lane], bool(self._simple[lane]))
        t = self._host_now
        for p in sorted(initial, key=repr):
            self.per_query_results[lane].add(p)
            self.per_query_log[lane].append((t, p))
        return initial

    def deregister_query(self, name: str) -> None:
        """Remove a live query: its lane becomes inert padding, reclaimed
        by the next :meth:`register_query`."""
        lane = self.lane_of(name)
        self._drain_pending()
        self.lane_specs[lane] = None
        self.executor.clear_lane(lane)
        self.per_query_results[lane] = set()
        self.per_query_log[lane] = []
        self.per_query_conflicted[lane] = False
        self._rebuild_tables()

    # -- interning ----------------------------------------------------------

    def _slot(self, vertex: object) -> int:
        s = self.slot_of.get(vertex)
        if s is None:
            if not self.free:
                self.compact()
            if not self.free:
                self._grow_slots(
                    _round_up(self.n_slots * 2, self.executor.n_multiple))
            s = self.free.pop()
            self.slot_of[vertex] = s
            self.vertex_of[s] = vertex
        return s

    def _grow_slots(self, new_n: int) -> None:
        """Append-only growth of the vertex axis."""
        if new_n <= self.n_slots:
            return
        self.executor.grow(n_slots=new_n)
        old_n = self.n_slots
        self.n_slots = new_n
        self.vertex_of.extend([None] * (new_n - old_n))
        self.free = list(range(new_n - 1, old_n - 1, -1)) + self.free

    # -- public API ----------------------------------------------------------

    def insert(self, u: object, v: object, label: str, ts: float) -> List[Set[Pair]]:
        return self.insert_batch([(u, v, label, ts)])

    def insert_batch(
        self, edges: Sequence[Tuple[object, object, str, float]]
    ) -> List[Set[Pair]]:
        """Ingest a micro-batch of append sgts (timestamp-ordered). Returns
        the NEW result pairs per lane."""
        return self.insert_batch_pending(edges).resolve()

    def insert_batch_pending(
        self, edges: Sequence[Tuple[object, object, str, float]]
    ) -> PendingResults:
        """Like :meth:`insert_batch` but defers the result transfer."""
        pending = PendingResults(self, self.q_cap)
        self._pending_fifo.append(pending)
        B = self.batch_size
        for i in range(0, len(edges), B):
            self._ingest_chunk(edges[i : i + B], pending)
        return pending

    def _ingest_chunk(self, edges, pending: PendingResults) -> None:
        t0 = obs.on and obs.now()
        B = self.batch_size
        src = np.zeros((B,), np.int64)
        dst = np.zeros((B,), np.int64)
        lab = np.zeros((B,), np.int64)
        ts = np.full((B,), NEG_INF, np.float32)
        mask = np.zeros((B,), bool)
        # every event of the chunk advances the clock, packed or not
        chunk_now = max(t for (_u, _v, _l, t) in edges)
        j = 0
        self._chunk_pinned.clear()
        try:
            for (u, v, label, t) in edges:
                li = self._label_index.get(label)
                if li is None:
                    continue  # outside the union alphabet: discarded
                si = self._slot(u)
                self._chunk_pinned.add(si)
                di = self._slot(v)
                self._chunk_pinned.add(di)
                src[j] = si
                dst[j] = di
                lab[j] = li
                ts[j] = t
                mask[j] = True
                j += 1
            self._host_now = max(self._host_now, chunk_now)
            if t0:
                obs.add("engine.intern", t0)
            if j == 0:
                self.executor.advance_clock(chunk_now)
                return
            new = self.executor.ingest_batch(
                src, dst, lab, ts, mask, chunk_now, self.tables
            )
        finally:
            self._chunk_pinned.clear()
        if self._check_conflict.any():
            flags = self._conflict_flags()
            for qi in np.nonzero(flags & self._check_conflict)[0]:
                self.per_query_conflicted[int(qi)] = True
        # decode deferred: snapshot the interner so later slot recycling
        # cannot remap this chunk's pairs
        t0 = obs.on and obs.now()
        pending._add(new, list(self.vertex_of), self._host_now)
        if t0:
            obs.add("engine.intern", t0)

    def _drain_pending(self, upto: Optional[PendingResults] = None) -> None:
        while self._pending_fifo:
            head = self._pending_fifo.popleft()
            head._decode_chunks()
            if head is upto:
                break

    def delete(self, u: object, v: object, label: str, ts: float) -> List[Set[Pair]]:
        """Explicit deletion (negative tuple). Returns invalidated pairs
        per lane."""
        return self.delete_batch([(u, v, label, ts)])

    def delete_batch(
        self, edges: Sequence[Tuple[object, object, str, float]]
    ) -> List[Set[Pair]]:
        """Delete a micro-batch of negative sgts through the chunked
        dispatch path (one delete dispatch per ``batch_size`` tuples).
        Returns the invalidated pairs per lane, unioned over the batch."""
        self._drain_pending()
        out: List[Set[Pair]] = [set() for _ in range(self.q_cap)]
        B = self.batch_size
        for i in range(0, len(edges), B):
            self._delete_chunk(edges[i : i + B], out)
        return out

    def _delete_chunk(self, edges, out: List[Set[Pair]]) -> None:
        t0 = obs.on and obs.now()
        B = self.batch_size
        src = np.zeros((B,), np.int64)
        dst = np.zeros((B,), np.int64)
        lab = np.zeros((B,), np.int64)
        mask = np.zeros((B,), bool)
        chunk_now = max(t for (_u, _v, _l, t) in edges)
        self._host_now = max(self._host_now, chunk_now)
        j = 0
        for (u, v, label, _t) in edges:
            li = self._label_index.get(label)
            if li is None or u not in self.slot_of or v not in self.slot_of:
                continue  # unknown label/vertex: nothing retained to drop
            src[j] = self.slot_of[u]
            dst[j] = self.slot_of[v]
            lab[j] = li
            mask[j] = True
            j += 1
        if t0:
            obs.add("engine.intern", t0)
        if j == 0:
            self.executor.advance_clock(chunk_now)
            return
        invalidated = self.executor.delete_batch(
            src, dst, lab, mask, chunk_now, self.tables)
        live = [qi for qi, _spec in self.live_items()]
        if not live:
            return
        t0 = obs.on and obs.now()
        # the lane list goes up in a blocking copy: inside the read
        idx = device_get(invalidated, "decode",
                         lambda m: torch.nonzero(m[live]))
        self.host_reads += 1
        for row, x, v in idx.tolist():
            qi = live[row]
            if self._simple[qi] and x == v:
                continue
            xv, vv = self.vertex_of[x], self.vertex_of[v]
            if xv is not None and vv is not None:
                out[qi].add((xv, vv))
        if t0:
            obs.add("engine.decode", t0)

    def expire(self, tau: Optional[float] = None) -> None:
        """Slide-boundary maintenance: adjacency masking + slot recycling."""
        t = tau if tau is not None else self._host_now
        self._host_now = max(self._host_now, t)
        live = self.executor.expire(t, self.max_window)
        self._recycle(live)

    def compact(self) -> None:
        self.expire()

    def _recycle(self, live: np.ndarray) -> None:
        t0 = obs.on and obs.now()
        dead_slots = [
            s for s, vtx in enumerate(self.vertex_of)
            if vtx is not None and not bool(live[s])
            and s not in self._chunk_pinned
        ]
        if dead_slots:
            self.executor.clear_slots(dead_slots)
            for s in dead_slots:
                vtx = self.vertex_of[s]
                self.vertex_of[s] = None
                del self.slot_of[vtx]
                self.free.append(s)
        if t0:
            obs.add("engine.recycle", t0)

    # -- result decoding ------------------------------------------------------

    def _decode_pairs(self, mat: torch.Tensor, simple: bool) -> Set[Pair]:
        t0 = obs.on and obs.now()
        pairs: Set[Pair] = set()
        self.host_reads += 1
        for x, v in _nonzero(mat).tolist():
            if simple and x == v:
                continue  # a simple path never revisits its source
            xv = self.vertex_of[x]
            vv = self.vertex_of[v]
            if xv is not None and vv is not None:
                pairs.add((xv, vv))
        if t0:
            obs.add("engine.decode", t0)
        return pairs

    def _decode_new_into(
        self,
        arr: torch.Tensor,                     # (Q, N, N) bool, device
        vertex_of: List[Optional[object]],     # interner snapshot at dispatch
        t: float,
        fresh: List[Set[Pair]],
    ) -> None:
        """Merge per-lane pairs NEW to the monotone result set into
        ``fresh`` (the host-side sets are the source of truth: after slot
        recycling the device diff may resurface reported pairs)."""
        t0 = obs.on and obs.now()
        self.host_reads += 1
        for q, x, v in _nonzero(arr).tolist():
            if self._simple[q] and x == v:
                continue
            xv = vertex_of[x]
            vv = vertex_of[v]
            if xv is None or vv is None:
                continue
            p = (xv, vv)
            if p not in self.per_query_results[q]:
                self.per_query_results[q].add(p)
                self.per_query_log[q].append((t, p))
                fresh[q].add(p)
        if t0:
            obs.add("engine.decode", t0)

    def current_results(self, qi: int = 0) -> Set[Pair]:
        """Snapshot view (explicit-window semantics) for lane ``qi``."""
        valid = self.executor.emit(self.tables)
        return self._decode_pairs(valid[qi], bool(self._simple[qi]))

    def retained_edges(self) -> List[Tuple[object, object, str, float]]:
        """The shared graph's current content as (u, v, label, ts) tuples
        in timestamp order."""
        adj = self.executor.dense_adj()
        idx = _nonzero(adj > NEG_INF)
        # the indices go up in a blocking copy: inside the read
        vals = device_get(adj, "decode", lambda a: a[tuple(
            torch.as_tensor(idx.T).to(self.device))]) \
            if idx.size else np.zeros((0,), np.float32)
        out: List[Tuple[object, object, str, float]] = []
        for (l, u, v), ts in zip(idx.tolist(), vals.tolist()):
            if l >= len(self.labels):
                continue
            uu = self.vertex_of[u]
            vv = self.vertex_of[v]
            if uu is None or vv is None:
                continue
            out.append((uu, vv, self.labels[l], float(ts)))
        out.sort(key=lambda e: e[3])
        return out

    def index_size(self, qi: Optional[int] = None) -> Tuple[int, int]:
        """(active roots, populated (x,v,s) entries); ``qi=None``
        aggregates over the whole group."""
        # compared on the host in float64, as the JAX engine does
        low = self._host_now - self._windows_np  # (Q,)
        pop = device_get(self.executor.dense_dist()) > low[:, None, None, None]
        if qi is not None:
            pop = pop[qi : qi + 1]
        roots = int(pop.any(axis=(2, 3)).sum())
        return roots, int(pop.sum())

    # -- state export / import ------------------------------------------------

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The device state as a dict of tensors in the canonical dense
        layout (the live tensors where the layout is dense; checkpoints
        copy them)."""
        self._drain_pending()
        return {"adj": self.executor.dense_adj(),
                "dist": self.executor.dense_dist(),
                "emitted": self.executor.dense_emitted(),
                "now": self.executor.now}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The device state as a dict of host numpy arrays (the layout the
        JAX engine's ``state_arrays`` has after ``np.asarray``)."""
        return {k: device_get(v) for k, v in self.state_tensors().items()}

    def load_state_arrays(self, state: Dict[str, object]) -> None:
        """Exact-shape reload (same capacities) from host arrays. For
        checkpoints of a group with other capacities, use
        :meth:`adopt_state`."""
        self._drain_pending()
        shapes = {"adj": self.executor.adj_shape,
                  "dist": self.executor.dist_shape,
                  "emitted": self.executor.dist_shape[:3]}
        for key, shape in shapes.items():
            got = tuple(np.shape(state[key]))
            if got != shape:
                raise ValueError(
                    f"state {key!r} has shape {got}, this engine holds {shape}")
        self.executor.place({k: np.asarray(v) for k, v in state.items()})
        self._host_now = float(np.asarray(state["now"]))

    def adopt_state(
        self,
        state: Dict[str, object],
        lane_names: Sequence[Optional[str]],
        labels: Sequence[str],
    ) -> None:
        """Load checkpointed state (tensors or host arrays) whose
        Q/K/label/vertex capacities may differ from this engine's. Lanes
        are matched by query NAME, adjacency rows by label NAME; slot
        indices are positional (the interner refers to them), so a smaller
        vertex capacity is padded and a LARGER checkpoint grows this engine
        first. The live query sets must agree (raises ``ValueError``).
        Labels only the checkpoint has are appended. The padded host
        arrays are placed through the executor (an ELL or row-sparse
        executor packs them), on this engine's device."""
        self._drain_pending()
        adj_ck = _host(state["adj"])
        dist_ck = _host(state["dist"])
        emitted_ck = _host(state["emitted"])
        ck_n = adj_ck.shape[1]
        if ck_n > self.n_slots:
            self._grow_slots(_round_up(ck_n, self.executor.n_multiple))
        ours = {spec.name: qi for qi, spec in self.live_items()}
        theirs = {name: qi for qi, name in enumerate(lane_names) if name is not None}
        if set(ours) != set(theirs):
            raise ValueError(
                f"checkpointed query set {sorted(theirs)} does not match "
                f"registered set {sorted(ours)}"
            )
        for lab in labels:
            if lab not in self._label_index:
                self._label_index[lab] = len(self.labels)
                self.labels = self.labels + (lab,)
        self._rebuild_tables()
        self._repad_arrays()
        adj = np.full(self.executor.adj_shape, NEG_INF, np.float32)
        for li_ck, lab in enumerate(labels):
            adj[self._label_index[lab], :ck_n, :ck_n] = adj_ck[li_ck]
        dist = np.full(self.executor.dist_shape, NEG_INF, np.float32)
        emitted = np.zeros(self.executor.dist_shape[:3], bool)
        # states beyond a lane's own dfa.k are -inf padding (no transition
        # scatters into them), so the K prefix carries everything real in
        # either direction
        kk = min(dist_ck.shape[3], self.k)
        for name, qi in ours.items():
            dist[qi, :ck_n, :ck_n, :kk] = dist_ck[theirs[name], :, :, :kk]
            emitted[qi, :ck_n, :ck_n] = emitted_ck[theirs[name]]
        now = np.float32(_host(state["now"]))
        self.executor.place(
            {"adj": adj, "dist": dist, "emitted": emitted, "now": now})
        self._host_now = float(now)

    def interner_state(self) -> Dict[str, object]:
        """Vertex interner as JSON-able metadata with type tags."""
        return {
            "format": 2,
            "entries": [
                [_encode_vertex(v), int(slot)]
                for v, slot in sorted(self.slot_of.items(), key=lambda kv: kv[1])
            ],
        }

    def load_interner(self, state: Dict) -> None:
        if (isinstance(state, dict) and state.get("format") == 2
                and isinstance(state.get("entries"), list)):
            self.slot_of = {
                _decode_vertex(enc): int(slot) for enc, slot in state["entries"]
            }
        else:  # legacy v1: untyped str keys, int guessed on load
            self.slot_of = {_maybe_int(k): v for k, v in state.items()}
        self.vertex_of = [None] * self.n_slots
        for vtx, slot in self.slot_of.items():
            self.vertex_of[slot] = vtx
        used = set(self.slot_of.values())
        self.free = [s for s in range(self.n_slots - 1, -1, -1) if s not in used]

    def results_state(self) -> Dict[str, object]:
        self._drain_pending()
        return {
            "format": 2,
            "results": {
                spec.name: [
                    [_encode_vertex(a), _encode_vertex(b)]
                    for (a, b) in sorted(self.per_query_results[qi], key=repr)
                ]
                for qi, spec in self.live_items()
            },
            "conflicted": {
                spec.name: self.per_query_conflicted[qi]
                for qi, spec in self.live_items()
            },
        }

    def load_results_state(self, state: Dict[str, object]) -> None:
        tagged = state.get("format", 1) >= 2
        for qi, spec in self.live_items():
            pairs = state["results"][spec.name]
            if tagged:
                self.per_query_results[qi] = {
                    (_decode_vertex(a), _decode_vertex(b)) for a, b in pairs
                }
            else:
                self.per_query_results[qi] = {tuple(p) for p in pairs}
            self.per_query_log[qi] = []
            self.per_query_conflicted[qi] = bool(state["conflicted"][spec.name])


def _encode_vertex(v: object) -> List:
    """Type-tagged JSON-able encoding of a vertex id (the JAX package's
    format, so interner states carry across)."""
    if isinstance(v, bool):  # before int: bool is an int subclass
        return ["b", bool(v)]
    if isinstance(v, int):
        return ["i", int(v)]
    if isinstance(v, float):
        return ["f", float(v)]
    if isinstance(v, str):
        return ["s", v]
    if isinstance(v, tuple):
        return ["t", [_encode_vertex(x) for x in v]]
    import base64
    import pickle

    return ["p", base64.b64encode(pickle.dumps(v)).decode("ascii")]


def _decode_vertex(enc: Sequence) -> object:
    tag, val = enc
    if tag == "b":
        return bool(val)
    if tag == "i":
        return int(val)
    if tag == "f":
        return float(val)
    if tag == "s":
        return str(val)
    if tag == "t":
        return tuple(_decode_vertex(x) for x in val)
    if tag == "p":
        import base64
        import pickle

        return pickle.loads(base64.b64decode(val))
    raise ValueError(f"unknown vertex tag {tag!r}")


def _maybe_int(s: str):
    """Legacy v1 interner decoding (type-guessing; kept for old states)."""
    try:
        return int(s)
    except ValueError:
        return s


class DenseRPQEngine(BatchedDenseRPQEngine):
    """Streaming RPQ engine for one query — the Q=1 view over the batched
    core. ``path_semantics="simple"`` flags possibly over-reporting
    windows in :attr:`conflicted` (the service falls back to the
    reference RSPQ)."""

    def __init__(
        self,
        dfa: DFA,
        window: float,
        n_slots: int = 128,
        batch_size: int = 32,
        backend=None,
        path_semantics: str = "arbitrary",
        executor: Optional[Executor] = None,
        frontier: str = "off",
        frontier_cap: int = 32,
        adj_layout: str = "dense",
        ell_cap: int = 8,
        dist_layout: str = "dense",
        dist_cap: int = 16,
        device: DeviceLike = None,
    ):
        super().__init__(
            [RegisteredQuery("q0", dfa, float(window), path_semantics)],
            n_slots=n_slots, batch_size=batch_size, backend=backend,
            executor=executor, frontier=frontier, frontier_cap=frontier_cap,
            adj_layout=adj_layout, ell_cap=ell_cap,
            dist_layout=dist_layout, dist_cap=dist_cap, device=device,
        )
        self.dfa = dfa
        self.window = float(window)
        self.path_semantics = path_semantics
        # the legacy single-query round's table (relax_round, closure,
        # valid_pairs), on the engine's device
        self.tt = TransitionTable.from_dfa(dfa, device=self.device)

    # -- Q=1 adapters --------------------------------------------------------

    @property
    def arrays(self) -> EngineArrays:
        """The Q=1 state with the adjacency as the canonical dense slab,
        whatever the layout."""
        b = self.executor.arrays
        return EngineArrays(self.executor.dense_adj(),
                            self.executor.dense_dist()[0], b.emitted[0], b.now)

    @arrays.setter
    def arrays(self, a: EngineArrays) -> None:
        adj = a.adj
        if self.executor.adj_layout == "ell":
            adj = self.executor.pack_adj(device_get(torch.as_tensor(adj)))
        dist = a.dist[None]
        if self.executor.dist_layout == "row_sparse":
            dist = self.executor.pack_dist(device_get(torch.as_tensor(dist)))
        self.executor.set_arrays(BatchedEngineArrays(
            adj, dist, a.emitted[None], a.now))

    @property
    def results(self) -> Set[Pair]:
        self._drain_pending()
        return self.per_query_results[0]

    @results.setter
    def results(self, value: Set[Pair]) -> None:
        self.per_query_results[0] = set(value)

    @property
    def result_log(self) -> List[Tuple[float, Pair]]:
        return self.per_query_log[0]

    @property
    def conflicted(self) -> bool:
        return self.per_query_conflicted[0]

    @conflicted.setter
    def conflicted(self, value: bool) -> None:
        self.per_query_conflicted[0] = bool(value)

    def insert(self, u: object, v: object, label: str, ts: float) -> Set[Pair]:
        return super().insert_batch([(u, v, label, ts)])[0]

    def insert_batch(self, edges) -> Set[Pair]:
        return super().insert_batch(edges)[0]

    def delete(self, u: object, v: object, label: str, ts: float) -> Set[Pair]:
        return super().delete(u, v, label, ts)[0]

    def current_results(self) -> Set[Pair]:
        return super().current_results(0)

    def index_size(self) -> Tuple[int, int]:
        return super().index_size(0)


def make_churn_oracle(
    dfa: DFA,
    live_group: BatchedDenseRPQEngine,
    window: float,
    n_slots: int,
    path_semantics: str = "arbitrary",
    device: DeviceLike = None,
) -> Tuple[DenseRPQEngine, Set[Pair]]:
    """Fresh-engine oracle for a query registered mid-stream, the
    construction the churn tests and ``chip_smoke.py``'s churn phase
    assert against. Exact by this recipe, in this order:

    1. sync the fresh engine's clock to the live group's ``now`` BEFORE
       seeding (expire() on the empty engine), so the seed's emitted
       baseline is "valid over the current window", the same baseline
       :meth:`BatchedDenseRPQEngine.register_query` records;
    2. feed the group's :meth:`~BatchedDenseRPQEngine.retained_edges` as
       ONE batch: the closure fixpoint depends only on the final
       adjacency, and one evaluation at the synced clock emits exactly the
       pairs valid over the live window;
    3. replay the tail per-tuple (``batch_size = 1``: no boundary skew).

    ``device=None`` builds on the live group's device. Returns (oracle,
    seed_results); seed_results must equal the live registration's
    initial answer set."""
    retained = live_group.retained_edges()
    oracle = DenseRPQEngine(dfa, window, n_slots=n_slots,
                            batch_size=max(1, len(retained)),
                            path_semantics=path_semantics,
                            device=live_group.device if device is None else device)
    oracle.expire(live_group.host_now)
    seed = oracle.insert_batch(retained) if retained else set()
    oracle.batch_size = 1
    return oracle, seed
