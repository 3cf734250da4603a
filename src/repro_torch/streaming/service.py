"""Persistent-query service: the end-to-end serving driver — the
counterpart of ``repro.streaming.service`` for the local and the mesh
executor with the dense or ELL adjacency, the dense or row-sparse dist and
every frontier mode.

Register RPQs (per-query engine choice + path semantics), ingest an
ordered sgt stream with eager evaluation and lazy expiration (slide
interval β), and emit an append-only result stream per query (the paper's
execution model, §2, §5.1).

Every query registered with ``engine="dense"`` folds into ONE
:class:`~repro_torch.core.engine.BatchedDenseRPQEngine` on the CUDA card
(``device=None``), whose closure rounds run kernel B1 (dense adjacency) or
kernel B5 (``adj_layout="ell"``), and whose row-sparse frontier dispatches
gather their rows with kernel B6 (``dist_layout="row_sparse"``); with
``backend="mxu_bucket"`` the rounds run on int32 levels (kernel B3, or B5
on levels with the ELL adjacency); reference
engines (the paper-faithful pointer oracles) stay on the per-query host
path.

Kept from the reference: live register/deregister, :class:`IngestReport`
(new pairs, deletion invalidations, RSPQ fallbacks, per-call frontier
telemetry), the RSPQ fallback for conflicted simple-path lanes, the
bounded async-decode FIFO (``async_decode``/``async_depth``),
``adaptive_batch`` with its hold on a healthy frontier, the frontier modes
(``frontier``/``frontier_cap``, per-interval deltas in
:attr:`PersistentQueryService.frontier_log`) and the ELL adjacency
(``adj_layout``/``ell_cap``, per-interval snapshots in
:attr:`PersistentQueryService.adjacency_log`) and the row-sparse dist
(``dist_layout``/``dist_cap``, per-interval snapshots in
:attr:`PersistentQueryService.dist_log`).

Fault tolerance: :meth:`PersistentQueryService.snapshot` checkpoints the
service through :mod:`repro_torch.checkpoint.ckpt` in the JAX package's
format — the dense group's state in the canonical dense layout, its live
query set lane by lane, label order, interner, results and learned
capacities in the manifest, reference engines as pickled leaves — and
:meth:`~PersistentQueryService.restore` re-attaches a freshly registered
service, matching lanes by query name and adjacency rows by label name,
so either package restores what the other wrote, across capacity and
layout differences. A query that fell back to the reference RSPQ
checkpoints as a reference engine, so a service restoring such a
snapshot registers it with ``engine="reference"``; registered as a dense
simple lane again, the live query sets differ (``ValueError``), as in the
JAX package.

``executor="mesh"`` runs the group on a
:class:`~repro_torch.distributed.executor.MeshExecutor`: lanes sharded
over every visible CUDA card (``device=None``) or over the given device
(``device="cpu"``: one shard on the CPU); a ``MeshExecutor`` instance
with any device grid passes through as any executor does.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Set, Tuple, Union

import numpy as np

from .. import obs
from ..core.automaton import compile_query
from ..core.contraction import resolve_backend
from ..core.engine import BatchedDenseRPQEngine, PendingResults, RegisteredQuery
from ..core.executor import Executor, LocalExecutor, _next_pow2, check_options
from ..core.reference import RAPQ, RSPQ
from ..distributed.executor import MeshExecutor
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class QueryStats:
    tuples: int = 0
    results: int = 0
    conflicted: bool = False
    latencies_us: Optional[List[float]] = None

    @property
    def p99_us(self) -> float:
        """The 99th percentile of :attr:`latencies_us` (0.0 before any)."""
        lat = sorted(self.latencies_us or ())
        return lat[min(int(0.99 * len(lat)), len(lat) - 1)] if lat else 0.0


class IngestReport(Dict[str, Set[Tuple]]):
    """New result pairs per query (a plain dict), with the
    deletion-invalidated pairs in :attr:`invalidated`, the queries switched
    to the exact reference RSPQ path in :attr:`fallbacks` (name -> reason),
    the call's frontier telemetry in :attr:`frontier_stats` (empty with
    ``frontier="off"``) and the count of negative tuples the dense group
    processed in :attr:`deletions`."""

    def __init__(self, new: Dict[str, Set[Tuple]],
                 invalidated: Dict[str, Set[Tuple]],
                 fallbacks: Optional[Dict[str, str]] = None,
                 frontier_stats: Optional[Dict[str, object]] = None,
                 deletions: int = 0):
        super().__init__(new)
        self.invalidated: Dict[str, Set[Tuple]] = invalidated
        self.fallbacks: Dict[str, str] = dict(fallbacks or {})
        self.frontier_stats: Dict[str, object] = dict(frontier_stats or {})
        self.deletions: int = int(deletions)


class RSPQFallback:
    """Exact simple-path engine for a query evicted from the dense group
    after a conflict: the paper-faithful :class:`RSPQ` plus its own map of
    window-live edges, so explicit deletions rebuild a fresh RSPQ from the
    retained edges. ``results`` stays monotone across rebuilds and carries
    the dense lane's pre-switch results."""

    def __init__(self, dfa, window: float, emitted: Optional[Set[Tuple]] = None):
        self.dfa = dfa
        self.window = float(window)
        self._edges: Dict[Tuple, float] = {}
        self._rspq = RSPQ(dfa, window)
        self._emitted: Set[Tuple] = set(emitted or ())

    @property
    def results(self) -> Set[Tuple]:
        return self._emitted | self._rspq.results

    @property
    def conflicts_detected(self) -> int:
        return self._rspq.conflicts_detected

    def seed(self, edges, now: float) -> None:
        """Replay the dense group's retained edges and sync the clock."""
        for (u, v, label, ts) in edges:
            self._edges[(u, v, label)] = ts
            self._rspq.insert(u, v, label, ts)
        if now > float("-inf"):
            self._rspq.expire(now)

    def insert(self, u, v, label: str, ts: float) -> Set[Tuple]:
        self._edges[(u, v, label)] = ts
        before = self.results
        self._rspq.insert(u, v, label, ts)
        return self.results - before

    def delete(self, u, v, label: str, ts: float) -> Set[Tuple]:
        self._edges.pop((u, v, label), None)
        now = max(self._rspq.now, ts)
        # advance the clock BEFORE snapshotting validity, as the dense
        # engine's delete does
        self._rspq.expire(now)
        before_valid = self._rspq.current_results()
        self._emitted |= self._rspq.results
        fresh = RSPQ(self.dfa, self.window)
        low = now - self.window
        for (eu, ev, el), ets in sorted(self._edges.items(), key=lambda kv: kv[1]):
            if ets > low:
                fresh.insert(eu, ev, el, ets)
        fresh.expire(now)
        self._rspq = fresh
        return before_valid - fresh.current_results()

    def expire(self, tau: Optional[float] = None) -> None:
        self._rspq.expire(tau)
        if tau is not None:
            low = tau - self.window
            self._edges = {k: t for k, t in self._edges.items() if t > low}

    def current_results(self) -> Set[Tuple]:
        return self._rspq.current_results()


class PersistentQueryService:
    """The serving driver (see the module docstring). ``device=None``
    places the dense group on the CUDA card; without a card the first
    dense registration raises."""

    def __init__(self, window: float, slide: float,
                 executor: Union[str, Executor] = "local",
                 async_decode: bool = False,
                 async_depth: int = 1,
                 rspq_fallback: bool = True,
                 adaptive_batch: bool = False,
                 max_batch: int = 32,
                 frontier: str = "off",
                 frontier_cap: int = 32,
                 adj_layout: str = "dense",
                 ell_cap: int = 8,
                 dist_layout: str = "dense",
                 dist_cap: int = 16,
                 device: DeviceLike = None):
        if not isinstance(executor, Executor) and executor not in ("local",
                                                                   "mesh"):
            raise ValueError(
                f"unknown executor {executor!r} (local | mesh | instance)")
        check_options(frontier=frontier, adj_layout=adj_layout,
                      dist_layout=dist_layout)
        self._frontier = frontier
        self._frontier_cap = int(frontier_cap)
        self._adj_layout = adj_layout
        self._ell_cap = int(ell_cap)
        self._dist_layout = dist_layout
        self._dist_cap = int(dist_cap)
        #: (tuples_seen_so_far, adjacency_stats snapshot) history, one entry
        #: per slide boundary when the layout is "ell"
        self.adjacency_log: List[Tuple[int, Dict[str, object]]] = []
        #: (tuples_seen_so_far, dist_stats snapshot) history, one entry per
        #: slide boundary when the dist layout is "row_sparse"
        self.dist_log: List[Tuple[int, Dict[str, object]]] = []
        #: (tuples_seen_so_far, per-interval frontier stats delta) history
        self.frontier_log: List[Tuple[int, Dict[str, object]]] = []
        self._frontier_mark: Optional[Dict[str, object]] = None
        self.window = float(window)
        self.slide = float(slide)
        self._executor_spec = executor
        self._device = device
        self._async_decode = bool(async_decode)
        # bounded deferred-decode FIFO: up to `async_depth` dispatches may
        # be in flight before the oldest emit matrix is pulled to the host
        self._async_depth = max(1, int(async_depth))
        self._rspq_fallback = bool(rspq_fallback)
        self._adaptive_batch = bool(adaptive_batch)
        self._max_batch = max(1, int(max_batch))
        self._adapt_marks: Optional[Tuple[int, int]] = None
        #: (tuples_seen_so_far, chosen_size) history of adaptive decisions
        self.batch_size_log: List[Tuple[int, int]] = []
        self._ref_engines: Dict[str, object] = {}
        # dense queries: name -> registration kwargs; grouped lazily until
        # first ingest, then the group is LIVE and mutated in place
        self._dense_specs: Dict[str, Dict] = {}
        self._group: Optional[BatchedDenseRPQEngine] = None
        self._ingest_started = False
        self.stats: Dict[str, QueryStats] = {}
        self._next_expiry = slide

    def _make_executor(self, backend) -> Executor:
        if isinstance(self._executor_spec, Executor):
            return self._executor_spec
        options = dict(frontier=self._frontier, frontier_cap=self._frontier_cap,
                       adj_layout=self._adj_layout, ell_cap=self._ell_cap,
                       dist_layout=self._dist_layout, dist_cap=self._dist_cap)
        if self._executor_spec == "mesh":
            devices = None if self._device is None else [self._device]
            return MeshExecutor(devices, backend=backend, **options)
        return LocalExecutor(backend, device=self._device, **options)

    @staticmethod
    def _stats_delta(cur: Dict[str, object],
                     prev: Dict[str, object]) -> Dict[str, object]:
        """Difference two frontier-stat snapshots: counters subtract,
        level values (mode, cap, max_lane_rows) pass through, occupancy is
        recomputed over the interval's own rows (None when the interval
        did no dense-row-equivalent work)."""
        level_keys = ("mode", "cap", "max_lane_rows")
        delta = {
            k: (cur[k] - prev.get(k, 0)
                if isinstance(cur[k], int) and k not in level_keys
                else cur[k])
            for k in cur
        }
        dr = delta.get("dense_row_equiv", 0)
        delta["occupancy"] = (delta.get("rows_relaxed", 0) / dr) if dr else None
        return delta

    @staticmethod
    def _frontier_healthy(finterval: Dict[str, object]) -> bool:
        """True when the interval's frontier telemetry shows cheap, live
        dispatches: some ran, their row occupancy is under 5%, and none
        overflowed to the dense loop. An interval with no signal is not
        healthy."""
        if not finterval or not finterval.get("dispatches", 0):
            return False
        occ = finterval.get("occupancy")
        if occ is None:
            return False
        return occ < 0.05 and not finterval.get("fallbacks", 0)

    def _frontier_delta(self) -> Dict[str, object]:
        """Frontier-stat delta since the last mark (empty when the
        frontier is off or no dense group exists)."""
        if self._group is None or self._frontier == "off":
            return {}
        cur = self._group.executor.frontier_stats
        delta = self._stats_delta(cur, self._frontier_mark or {})
        self._frontier_mark = cur
        return delta

    @property
    def queries(self) -> Dict[str, object]:
        """name -> engine handling it (the batched group for dense queries)."""
        self._ensure_group()
        out: Dict[str, object] = dict(self._ref_engines)
        for name in self._dense_specs:
            out[name] = self._group
        return out

    def register(
        self,
        name: str,
        expr: str,
        engine: str = "dense",            # dense | reference
        path_semantics: str = "arbitrary",  # arbitrary | simple
        n_slots: int = 256,
        batch_size: int = 1,
        backend=None,
    ) -> Set[Tuple]:
        """Register a persistent query, before or after ingestion has
        started. A dense registration into a live group seeds the query
        over the retained graph and returns its initial result pairs; all
        other paths return an empty set. ``backend=None`` is kernel B1;
        ``"mxu_bucket"`` or a ``BucketBackend`` instance runs the
        level-quantized closure. The dense queries of one service share one
        backend configuration (backends compare by ``config_key``)."""
        if name in self.stats and (name in self._dense_specs
                                   or name in self._ref_engines):
            raise ValueError(f"query {name!r} already registered")
        if engine == "dense":
            backend = resolve_backend(backend)
            resolve_device(self._device)  # no card: raise now, not at ingest
        dfa = compile_query(expr)
        initial: Set[Tuple] = set()
        if engine == "dense":
            if self._group is not None and self._ingest_started:
                initial = self._group.register_query(
                    RegisteredQuery(name, dfa, self.window, path_semantics)
                )
                self._dense_specs[name] = dict(
                    dfa=dfa, path_semantics=path_semantics,
                    n_slots=self._group.n_slots,
                    batch_size=self._group.batch_size,
                    backend=self._group.backend,
                )
            else:
                self._dense_specs[name] = dict(
                    dfa=dfa, path_semantics=path_semantics, n_slots=n_slots,
                    batch_size=batch_size, backend=backend,
                )
                self._group = None  # rebuilt (empty) at next ingest
                if self._ingest_started:
                    # the FIRST dense query arriving mid-stream has nothing
                    # to seed from: materialize the group now
                    self._ensure_group()
        elif path_semantics == "simple":
            self._ref_engines[name] = RSPQ(dfa, self.window)
        else:
            self._ref_engines[name] = RAPQ(dfa, self.window)
        if name not in self.stats:  # a reused name keeps its history
            self.stats[name] = QueryStats(latencies_us=[])
        return initial

    def deregister(self, name: str) -> None:
        """Retire a persistent query mid-stream (a dense lane becomes
        inert padding; the stats entry is kept as history)."""
        if name in self._dense_specs:
            del self._dense_specs[name]
            if self._group is not None:
                if self._ingest_started:
                    self._group.deregister_query(name)
                else:
                    self._group = None  # rebuilt without it at next ingest
        elif name in self._ref_engines:
            del self._ref_engines[name]
        else:
            raise KeyError(f"no registered query named {name!r}")

    def _ensure_group(self) -> None:
        if self._group is not None or not self._dense_specs:
            return
        backends = {s["backend"] for s in self._dense_specs.values()}
        if len(backends) > 1:
            raise ValueError(f"dense queries must share one backend, got {backends}")
        backend = backends.pop()
        specs = [
            RegisteredQuery(name, s["dfa"], self.window, s["path_semantics"])
            for name, s in self._dense_specs.items()
        ]
        self._group = BatchedDenseRPQEngine(
            specs,
            n_slots=max(s["n_slots"] for s in self._dense_specs.values()),
            # the smallest requested micro-batch bounds the group's
            # batch-boundary skew for every member query
            batch_size=min(s["batch_size"] for s in self._dense_specs.values()),
            backend=backend,
            executor=self._make_executor(backend),
        )

    def _maybe_fallback(self, fallbacks: Dict[str, str], resolve_cb) -> None:
        """Route conflicted simple-path dense lanes to the exact reference
        RSPQ engine (seeded from the retained graph); record the switch."""
        if not self._rspq_fallback or self._group is None:
            return
        for qi, spec in list(self._group.live_items()):
            if spec.path_semantics != "simple":
                continue
            if not self._group.per_query_conflicted[qi]:
                continue
            t0 = obs.on and obs.now()
            resolve_cb()  # settle deferred decodes before mutating lanes
            name = spec.name
            fb = RSPQFallback(spec.dfa, spec.window,
                              emitted=self._group.per_query_results[qi])
            fb.seed(self._group.retained_edges(), self._group.host_now)
            self._group.deregister_query(name)
            del self._dense_specs[name]
            self._ref_engines[name] = fb
            fallbacks[name] = "conflict -> reference RSPQ"
            if name in self.stats:
                self.stats[name].conflicted = True
            if t0:
                obs.add("service.fallback", t0)

    def ingest(self, stream, record_latency: bool = False) -> IngestReport:
        """Feed the whole stream; returns an :class:`IngestReport`.

        With ``adaptive_batch=True`` dense inserts buffer into micro-batches
        whose size doubles (up to ``max_batch``) when the interval's no-op
        relaxation tail is large and halves when it is small, read from
        the executor's round counters at each slide boundary; decisions
        land in :attr:`batch_size_log`.

        ``record_latency=True`` traces the call: each query's dispatch
        times go to :attr:`stats` (``latencies_us``), and the layers'
        spans, the call itself as ``service.ingest``, to
        :data:`repro_torch.obs.RECORDER`."""
        if not record_latency:
            return self._ingest(stream, False)
        with obs.recording():
            t0 = obs.now()
            try:
                return self._ingest(stream, True)
            finally:
                obs.add("service.ingest", t0)

    def _ingest(self, stream, record_latency: bool) -> IngestReport:
        self._ensure_group()
        self._ingest_started = True
        new_results: Dict[str, Set[Tuple]] = {name: set() for name in self.stats}
        invalidated: Dict[str, Set[Tuple]] = {name: set() for name in self.stats}
        fallbacks: Dict[str, str] = {}
        # reading frontier_stats flushes the executor's queued counters (and
        # may grow the "auto" capacity), at the same points as the reference
        call_mark: Dict[str, object] = (
            dict(self._group.executor.frontier_stats)
            if self._group is not None and self._frontier != "off" else {})
        pending: Deque[PendingResults] = collections.deque()
        dense_buf: List = []               # adaptive micro-batch buffer
        del_buf: List = []                 # negative-tuple micro-batch buffer
        deletions = [0]                    # negative tuples seen by the group

        def resolve_pending(limit: int = 0) -> None:
            """Resolve outstanding decode handles down to ``limit``."""
            while len(pending) > limit:
                fresh = pending.popleft().resolve()
                for qi, spec in self._group.live_items():
                    new_results[spec.name] |= fresh[qi]

        def flush_dense() -> None:
            """Dispatch the buffered dense inserts as one micro-batch."""
            if not dense_buf:
                return
            batch = [(s.src, s.dst, s.label, s.ts) for s in dense_buf]
            t0 = time.perf_counter_ns() if record_latency else 0
            handle = self._group.insert_batch_pending(batch)
            pending.append(handle)
            resolve_pending(self._async_depth if self._async_decode else 0)
            dt = (time.perf_counter_ns() - t0) / 1e3 if record_latency else 0.0
            for qi, spec in self._group.live_items():
                st = self.stats[spec.name]
                st.tuples += len(batch)
                if record_latency:
                    st.latencies_us.extend([dt / len(batch)] * len(batch))
            dense_buf.clear()
            self._maybe_fallback(fallbacks, lambda: resolve_pending(0))

        def flush_deletes() -> None:
            """Dispatch the buffered negative tuples as one micro-batch."""
            if not del_buf:
                return
            resolve_pending()
            batch = [(s.src, s.dst, s.label, s.ts) for s in del_buf]
            t0 = time.perf_counter_ns() if record_latency else 0
            inv = self._group.delete_batch(batch)
            dt = (time.perf_counter_ns() - t0) / 1e3 if record_latency else 0.0
            for qi, spec in self._group.live_items():
                st = self.stats[spec.name]
                st.tuples += len(batch)
                invalidated[spec.name] |= inv[qi]
                if record_latency:
                    st.latencies_us.extend([dt / len(batch)] * len(batch))
            deletions[0] += len(batch)
            del_buf.clear()
            self._maybe_fallback(fallbacks, lambda: resolve_pending(0))

        def mark_interval() -> Dict[str, object]:
            """Per-interval telemetry: append the frontier delta since the
            last slide boundary to :attr:`frontier_log` (and the adjacency
            snapshot to :attr:`adjacency_log` under ELL, the dist snapshot
            to :attr:`dist_log` under the row-sparse dist); the delta
            steers the batch size below."""
            delta = self._frontier_delta()
            seen = max((self.stats[s.name].tuples
                        for _qi, s in self._group.live_items()),
                       default=0) if self._group is not None else 0
            if delta:
                self.frontier_log.append((seen, delta))
            if (self._group is not None
                    and self._group.executor.adj_layout == "ell"):
                self.adjacency_log.append(
                    (seen, self._group.executor.adjacency_stats))
            if (self._group is not None
                    and self._group.executor.dist_layout == "row_sparse"):
                self.dist_log.append((seen, self._group.executor.dist_stats))
            return delta

        def adapt_batch(finterval: Dict[str, object]) -> None:
            """Steer the dense micro-batch size from the interval's no-op
            relaxation tail, holding it while the frontier is healthy."""
            if not self._adaptive_batch or self._group is None:
                return
            ex = self._group.executor
            qr, uqr = ex.query_rounds_total, ex.unmasked_query_rounds_total
            if self._adapt_marks is not None:
                dqr = qr - self._adapt_marks[0]
                duqr = uqr - self._adapt_marks[1]
                if duqr > 0:
                    noop_frac = 1.0 - dqr / duqr
                    b = self._group.batch_size
                    # a live, healthy frontier already makes each dispatch
                    # cheap in proportion to its dirty rows: hold B
                    if noop_frac >= 0.3 and b < self._max_batch \
                            and not self._frontier_healthy(finterval):
                        b *= 2
                    elif noop_frac < 0.1 and b > 1:
                        b //= 2
                    if b != self._group.batch_size:
                        self._group.batch_size = b
                        seen = max((self.stats[s.name].tuples
                                    for _qi, s in self._group.live_items()),
                                   default=0)
                        self.batch_size_log.append((seen, b))
            self._adapt_marks = (qr, uqr)

        for sgt in stream:
            # lazy expiration at slide boundaries (eager evaluation)
            if sgt.ts >= self._next_expiry:
                flush_dense()
                flush_deletes()
                resolve_pending()
                t0 = obs.on and obs.now()
                if self._group is not None:
                    self._group.expire(sgt.ts)
                for eng in self._ref_engines.values():
                    eng.expire(sgt.ts)
                while self._next_expiry <= sgt.ts:
                    self._next_expiry += self.slide
                adapt_batch(mark_interval())
                if t0:
                    obs.add("service.expire", t0)
            # snapshot BEFORE the dense step: a fallback fired by this very
            # event must not re-feed the event to its new reference engine
            refs_this_event = list(self._ref_engines.items())
            if self._group is not None:
                if sgt.op == "+":
                    flush_deletes()
                    dense_buf.append(sgt)
                    if (not self._adaptive_batch
                            or len(dense_buf) >= self._group.batch_size):
                        flush_dense()
                else:
                    flush_dense()
                    del_buf.append(sgt)
                    if (not self._adaptive_batch
                            or len(del_buf) >= self._group.batch_size):
                        flush_deletes()
            t1 = obs.on and refs_this_event and obs.now()
            for name, eng in refs_this_event:
                t0 = time.perf_counter_ns() if record_latency else 0
                if sgt.op == "+":
                    res = eng.insert(sgt.src, sgt.dst, sgt.label, sgt.ts)
                    new_results[name] |= res
                else:
                    inv = eng.delete(sgt.src, sgt.dst, sgt.label, sgt.ts)
                    if inv:
                        invalidated[name] |= set(inv)
                st = self.stats[name]
                st.tuples += 1
                if record_latency:
                    st.latencies_us.append((time.perf_counter_ns() - t0) / 1e3)
            if t1:
                obs.add("service.reference", t1)
        flush_dense()
        flush_deletes()
        resolve_pending()
        t0 = obs.on and obs.now()
        for name in self.stats:
            st = self.stats[name]
            if name in self._dense_specs or name in self._ref_engines:
                st.results = len(self.results(name))
                st.conflicted = st.conflicted or self._conflicted(name)
        fstats: Dict[str, object] = {}
        if call_mark and self._group is not None:
            fstats = self._stats_delta(
                self._group.executor.frontier_stats, call_mark)
        report = IngestReport(new_results, invalidated, fallbacks, fstats,
                              deletions=deletions[0])
        if t0:
            obs.add("service.tail", t0)
        return report

    def results(self, name: str) -> Set[Tuple]:
        if name in self._dense_specs:
            self._ensure_group()
            return set(self._group.per_query_results[self._group.lane_of(name)])
        return set(self._ref_engines[name].results)

    def _conflicted(self, name: str) -> bool:
        if name in self._dense_specs and self._group is not None:
            return bool(self._group.per_query_conflicted[self._group.lane_of(name)])
        eng = self._ref_engines.get(name)
        return bool(getattr(eng, "conflicts_detected", 0)) if eng else False

    # -- state persistence ----------------------------------------------------

    def snapshot(self, directory: str, step: int, *,
                 wal_lsn: Optional[int] = None,
                 extra_meta: Optional[Dict[str, object]] = None,
                 async_save: bool = False,
                 _crash_after: Optional[str] = None) -> None:
        """Checkpoint the whole service. ``wal_lsn`` records the
        write-ahead-log position this snapshot covers (recovery replays
        only records past it); ``async_save=True`` defers the file IO to a
        background thread (the device->host copy still happens here, so
        the state is consistent whatever the stream does next);
        ``_crash_after`` is the chaos harness's mid-save kill switch
        (``ckpt.save``'s stages).

        The dense group's deferred-decode FIFO is drained FIRST: an
        in-flight async-decode batch has already mutated device state, so
        saving before its results land would snapshot an emitted mask
        ahead of the recorded results, and restore + replay would drop
        those pairs."""
        from ..checkpoint import ckpt

        self._ensure_group()
        if self._group is not None:
            self._group._drain_pending()
        state: Dict[str, object] = {}
        extra: Dict[str, object] = {
            "step": step,
            "next_expiry": self._next_expiry,
            "reference": sorted(self._ref_engines),
        }
        if wal_lsn is not None:
            extra["wal_lsn"] = int(wal_lsn)
        if extra_meta:
            # caller metadata (the supervisor's churn catalog) rides the
            # manifest; reserved keys stay ours
            for k, v in extra_meta.items():
                extra.setdefault(k, v)
        if self._group is not None:
            ex = self._group.executor
            state["dense_group"] = self._group.state_tensors()
            extra["dense"] = {
                # the LIVE query set, lane by lane (None = inert padding)
                "order": [s.name if s is not None else None
                          for s in self._group.lane_specs],
                "labels": list(self._group.labels),
                "interner": self._group.interner_state(),
                # learned capacities (pow2-bucketed): a restored service
                # starts at these instead of re-learning them
                "capacities": {
                    "frontier_cap": int(ex.frontier_cap),
                    "ell_cap": int(ex.ell_cap),
                    "dist_cap": int(ex.dist_cap),
                    "dist_ovf_cap": (int(ex.dist_ovf_cap)
                                     if ex.dist_ovf_cap is not None else None),
                },
                **self._group.results_state(),
            }
        for name, eng in self._ref_engines.items():
            state[f"refeng.{name}"] = ckpt.pickle_leaf(eng)
        if async_save:
            ckpt.async_save(directory, step, state, extra=extra,
                            _crash_after=_crash_after)
        else:
            ckpt.save(directory, step, state, extra=extra,
                      _crash_after=_crash_after)

    def restore(self, directory: str) -> int:
        """Re-attach to the latest committed checkpoint under
        ``directory`` (written by this package or the JAX one); returns
        its step. The registered query set must be the checkpoint's."""
        from ..checkpoint import ckpt

        self._ensure_group()
        like: Dict[str, object] = {}
        if self._group is not None:
            # dtypes only (shapes come from the file): the arrays stay on
            # the host until adopt_state places them
            like["dense_group"] = {
                "adj": np.zeros((0,), np.float32),
                "dist": np.zeros((0,), np.float32),
                "emitted": np.zeros((0,), bool),
                "now": np.zeros((), np.float32),
            }
        for name in self._ref_engines:
            like[f"refeng.{name}"] = ckpt.pickle_like()
        state, extra = ckpt.restore(directory, like=like)
        if self._group is not None:
            meta = extra["dense"]
            # adopt the snapshot's learned capacities first (never shrink),
            # so the placement below packs at the occupancy already learned
            caps = meta.get("capacities", {})
            ex = self._group.executor
            if caps.get("frontier_cap"):
                ex.frontier_cap = max(
                    ex.frontier_cap, _next_pow2(int(caps["frontier_cap"])))
            if caps.get("ell_cap"):
                ex.ell_cap = max(ex.ell_cap, _next_pow2(int(caps["ell_cap"])))
            if caps.get("dist_cap"):
                ex.dist_cap = max(ex.dist_cap,
                                  _next_pow2(int(caps["dist_cap"])))
            if caps.get("dist_ovf_cap"):
                prev = ex.dist_ovf_cap if ex.dist_ovf_cap is not None else 1
                ex.dist_ovf_cap = max(
                    prev, _next_pow2(int(caps["dist_ovf_cap"])))
            # lane-by-name adoption across Q/K/label/slot padding and
            # layouts; raises if the LIVE query sets differ
            self._group.adopt_state(
                state["dense_group"],
                meta["order"],
                meta.get("labels", list(self._group.labels)),
            )
            self._group.load_interner(meta["interner"])
            self._group.load_results_state(meta)
        for name in self._ref_engines:
            self._ref_engines[name] = ckpt.unpickle_leaf(state[f"refeng.{name}"])
        self._next_expiry = float(extra.get("next_expiry", self.slide))
        self._ingest_started = True
        return int(extra["step"])
