"""Persistent-query service: the end-to-end serving driver — the
counterpart of ``repro.streaming.service`` for the local executor with the
dense layouts and ``frontier="off"``.

Register RPQs (per-query engine choice + path semantics), ingest an
ordered sgt stream with eager evaluation and lazy expiration (slide
interval β), and emit an append-only result stream per query (the paper's
execution model, §2, §5.1).

Every query registered with ``engine="dense"`` folds into ONE
:class:`~repro_torch.core.engine.BatchedDenseRPQEngine` on the CUDA card
(``device=None``), whose closure rounds run kernel B1; reference engines
(the paper-faithful pointer oracles) stay on the per-query host path.

Kept from the reference: live register/deregister, :class:`IngestReport`
(new pairs, deletion invalidations, RSPQ fallbacks), the RSPQ fallback for
conflicted simple-path lanes, the bounded async-decode FIFO
(``async_decode``/``async_depth``) and ``adaptive_batch``. Not yet ported,
and raising with their ROADMAP item: ``snapshot``/``restore`` (A10),
``executor="mesh"`` (A11), the frontier (A6) and the sparse layouts (A8,
A9).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Set, Tuple, Union

from ..core.automaton import compile_query
from ..core.contraction import resolve_backend
from ..core.engine import BatchedDenseRPQEngine, PendingResults, RegisteredQuery
from ..core.executor import Executor, LocalExecutor, check_ported
from ..core.reference import RAPQ, RSPQ
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class QueryStats:
    tuples: int = 0
    results: int = 0
    conflicted: bool = False
    wall_s: float = 0.0
    p99_us: float = 0.0
    latencies_us: Optional[List[float]] = None


class IngestReport(Dict[str, Set[Tuple]]):
    """New result pairs per query (a plain dict), with the
    deletion-invalidated pairs in :attr:`invalidated`, the queries switched
    to the exact reference RSPQ path in :attr:`fallbacks` (name -> reason),
    the frontier telemetry in :attr:`frontier_stats` (always empty: the
    frontier is not ported) and the count of negative tuples the dense
    group processed in :attr:`deletions`."""

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
        if executor == "mesh":
            raise NotImplementedError(
                "executor='mesh' is not yet ported (ROADMAP A11)")
        if not isinstance(executor, Executor) and executor != "local":
            raise ValueError(
                f"unknown executor {executor!r} (local | mesh | instance)")
        check_ported(frontier=frontier, adj_layout=adj_layout,
                     dist_layout=dist_layout)
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
        return LocalExecutor(backend, device=self._device)

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
        other paths return an empty set. ``backend=None`` is kernel B1."""
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

    def ingest(self, stream, record_latency: bool = False) -> IngestReport:
        """Feed the whole stream; returns an :class:`IngestReport`.

        With ``adaptive_batch=True`` dense inserts buffer into micro-batches
        whose size doubles (up to ``max_batch``) when the interval's no-op
        relaxation tail is large and halves when it is small, read from
        the executor's round counters at each slide boundary; decisions
        land in :attr:`batch_size_log`."""
        self._ensure_group()
        self._ingest_started = True
        new_results: Dict[str, Set[Tuple]] = {name: set() for name in self.stats}
        invalidated: Dict[str, Set[Tuple]] = {name: set() for name in self.stats}
        fallbacks: Dict[str, str] = {}
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

        def adapt_batch() -> None:
            """Steer the dense micro-batch size from the interval's no-op
            relaxation tail (the frontier health check of the reference
            never holds B here: the frontier is off)."""
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
                    if noop_frac >= 0.3 and b < self._max_batch:
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
                if self._group is not None:
                    self._group.expire(sgt.ts)
                for eng in self._ref_engines.values():
                    eng.expire(sgt.ts)
                while self._next_expiry <= sgt.ts:
                    self._next_expiry += self.slide
                adapt_batch()
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
        flush_dense()
        flush_deletes()
        resolve_pending()
        for name in self.stats:
            st = self.stats[name]
            if name in self._dense_specs or name in self._ref_engines:
                st.results = len(self.results(name))
                st.conflicted = st.conflicted or self._conflicted(name)
            if st.latencies_us:
                lat = sorted(st.latencies_us)
                st.p99_us = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
        return IngestReport(new_results, invalidated, fallbacks, {},
                            deletions=deletions[0])

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

    # -- state persistence (not yet ported) -----------------------------------

    def snapshot(self, directory: str, step: int, **kwargs) -> None:
        raise NotImplementedError(
            "PersistentQueryService.snapshot is not yet ported (ROADMAP A10)")

    def restore(self, directory: str) -> int:
        raise NotImplementedError(
            "PersistentQueryService.restore is not yet ported (ROADMAP A10)")
