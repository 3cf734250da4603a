"""Supervised streaming service: WAL-backed crash recovery, deterministic
fault injection, backpressure, and graceful degradation — the counterpart
of ``repro.streaming.supervisor``.

:class:`ServiceSupervisor` wraps a :class:`~repro_torch.streaming.service.\
PersistentQueryService` with the machinery that turns "fast on gmark" into
"survivable under production traffic":

* **Write-ahead log + exact replay** — every micro-batch is appended to a
  :class:`~repro_torch.streaming.wal.WriteAheadLog` (fsync'd) BEFORE dispatch;
  periodic async snapshots (``ckpt.async_save`` + the atomic LATEST
  protocol) record the covered WAL position. On ANY crash the supervisor
  rebuilds the service, restores the latest COMMITTED checkpoint, and
  replays the WAL suffix through the normal ingest path — recovery is
  ``O(events since snapshot)``, and because every engine mode is
  bit-identical per event, the reconstructed result stream equals the
  uninterrupted run's exactly (``verify_replay=True`` asserts it inline:
  a replayed batch whose results diverge from what was recorded before
  the crash raises :class:`ReplayDivergence`).

* **Deterministic fault injection** — a seedable :class:`FaultPlan`
  schedules crashes before/after dispatch, mid-snapshot (through
  ``ckpt.save``'s staged ``_crash_after`` kill switch), during replay,
  slow-dispatch stragglers, and transient decode errors with bounded
  retry/backoff. Every fault fires exactly once, so chaos runs are
  reproducible from the seed alone.

* **Backpressure** — arrivals land in a :class:`BoundedIngestQueue` with
  explicit policies: ``"block"`` (the producer stalls while the service
  drains — counted, nothing dropped) or ``"shed-oldest"``/``"shed-newest"``
  (load shedding with exact drop counters; a shed event is GONE — it is
  shed before the WAL, so replay stays consistent with what the engine
  actually saw).

* **Graceful degradation** — a :class:`CircuitBreaker` watches the
  per-interval overflow-drain rate (frontier fallbacks + ELL spill drains
  + row-sparse dist drains). When pressure exceeds the trip threshold the
  supervisor performs a controlled handover onto the dense fallbacks
  (``frontier="off"``, ``adj_layout="dense"``, ``dist_layout="dense"``)
  via sync-snapshot → rebuild → restore (canonical-dense checkpoints make
  this loss-free), and re-arms back to the preferred sparse config after a
  quiet period. Per-interval telemetry rides :attr:`health_log` in the
  same ``*_log`` pattern as the service's frontier/adjacency/dist logs.

The supervisor OWNS the batching: the stream is cut into ``batch_events``
micro-batches that are the WAL's unit of append and replay, so the
recovered run re-groups events exactly like the original did (grouping is
part of the determinism contract — B > 1 batch-boundary skew is identical
when the batches are identical).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import random
import time
from typing import Callable, Deque, Dict, Iterable, List, Optional, Set, Tuple

from ..checkpoint import ckpt
from ..checkpoint.ckpt import SimulatedCrash
from .stream import SGT
from .wal import WALRecord, WriteAheadLog

QUEUE_POLICIES = ("block", "shed-oldest", "shed-newest")

#: the degradation ladder's bottom rung: every layout pinned to its dense
#: fallback — no overflow surface left to drain
DENSE_FALLBACK_OVERRIDES = {
    "frontier": "off",
    "adj_layout": "dense",
    "dist_layout": "dense",
}


class InjectedCrash(RuntimeError):
    """A FaultPlan-scheduled crash (the in-process stand-in for SIGKILL)."""


class TransientDecodeError(RuntimeError):
    """A FaultPlan-scheduled transient failure: retryable, not a crash."""


class ReplayDivergence(AssertionError):
    """WAL replay produced different results than the pre-crash run
    recorded for the same lsn — the replay-identity contract is broken."""


class FaultPlan:
    """Deterministic, seedable fault schedule. Keys are the WAL lsn of the
    batch (dispatch faults) or the snapshot ordinal (mid-snapshot faults);
    every scheduled fault fires EXACTLY ONCE — the retried/replayed
    occurrence of the same lsn proceeds — so a chaos run always
    terminates and is reproducible from the constructor arguments.

    ``crash_mid_snapshot`` maps snapshot ordinal → a ``ckpt.save`` stage
    (``"shards" | "manifest" | "rename"``), covering a kill at every point
    of the commit protocol.
    """

    def __init__(self,
                 crash_before_dispatch: Iterable[int] = (),
                 crash_after_dispatch: Iterable[int] = (),
                 crash_during_replay: Iterable[int] = (),
                 crash_mid_snapshot: Optional[Dict[int, str]] = None,
                 slow_dispatch: Optional[Dict[int, float]] = None,
                 transient_errors: Optional[Dict[int, int]] = None):
        self._before = set(int(x) for x in crash_before_dispatch)
        self._after = set(int(x) for x in crash_after_dispatch)
        self._replay = set(int(x) for x in crash_during_replay)
        self._mid_snapshot = dict(crash_mid_snapshot or {})
        self._slow = dict(slow_dispatch or {})
        self._transient = dict(transient_errors or {})
        for stage in self._mid_snapshot.values():
            if stage not in ("shards", "manifest", "rename"):
                raise ValueError(f"unknown ckpt crash stage {stage!r}")

    @classmethod
    def chaos(cls, seed: int, n_batches: int,
              crash_rate: float = 0.05,
              straggler_rate: float = 0.05,
              straggler_s: float = 0.002,
              transient_rate: float = 0.05,
              snapshot_crash_every: int = 0) -> "FaultPlan":
        """A reproducible mixed plan over ``n_batches`` lsns: crashes split
        between before/after/replay hooks, stragglers, and transient
        errors, all drawn from one seeded RNG."""
        rng = random.Random(seed)
        before, after, replay = set(), set(), set()
        slow: Dict[int, float] = {}
        transient: Dict[int, int] = {}
        for lsn in range(1, n_batches + 1):
            r = rng.random()
            if r < crash_rate:
                rng.choice((before, after, replay)).add(lsn)
            elif r < crash_rate + straggler_rate:
                slow[lsn] = straggler_s * (1 + rng.random())
            elif r < crash_rate + straggler_rate + transient_rate:
                transient[lsn] = rng.randint(1, 2)
        mid: Dict[int, str] = {}
        if snapshot_crash_every:
            for i, stage in enumerate(("shards", "manifest", "rename")):
                mid[(i + 1) * snapshot_crash_every] = stage
        return cls(before, after, replay, mid, slow, transient)

    # -- fire-once hooks ------------------------------------------------------

    def take_crash(self, hook: str, key: int) -> bool:
        pool = {"before_dispatch": self._before,
                "after_dispatch": self._after,
                "during_replay": self._replay}[hook]
        if key in pool:
            pool.discard(key)
            return True
        return False

    def take_snapshot_crash(self, ordinal: int) -> Optional[str]:
        return self._mid_snapshot.pop(ordinal, None)

    def take_sleep(self, lsn: int) -> float:
        return self._slow.pop(lsn, 0.0)

    def take_transient(self, lsn: int) -> bool:
        left = self._transient.get(lsn, 0)
        if left > 0:
            self._transient[lsn] = left - 1
            return True
        return False

    @property
    def exhausted(self) -> bool:
        return not (self._before or self._after or self._replay
                    or self._mid_snapshot or self._slow
                    or any(self._transient.values()))


class BoundedIngestQueue:
    """Bounded arrival buffer with explicit overload policies.

    ``push`` returns True when the event was accepted. Under ``"block"``
    a full queue REFUSES the event (the caller must drain and re-offer —
    the producer stalls; :attr:`blocked` counts the stalls). Under
    ``"shed-oldest"`` the oldest queued event is dropped to make room;
    under ``"shed-newest"`` the arriving event itself is dropped. All
    drops are counted in :attr:`shed` — load shedding is explicit and
    observable, never silent."""

    def __init__(self, cap: int, policy: str = "block"):
        if cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {cap}")
        if policy not in QUEUE_POLICIES:
            raise ValueError(
                f"unknown queue policy {policy!r} "
                f"({' | '.join(QUEUE_POLICIES)})")
        self.cap = int(cap)
        self.policy = policy
        self._q: Deque[SGT] = collections.deque()
        self.shed = 0
        self.blocked = 0
        self.accepted = 0
        self.high_water = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.cap

    def push(self, evt: SGT) -> bool:
        if self.full:
            if self.policy == "block":
                self.blocked += 1
                return False
            if self.policy == "shed-oldest":
                self._q.popleft()
                self.shed += 1
            else:  # shed-newest: the arrival itself is dropped
                self.shed += 1
                return True
        self._q.append(evt)
        self.accepted += 1
        self.high_water = max(self.high_water, len(self._q))
        return True

    def take(self, n: int) -> List[SGT]:
        out: List[SGT] = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out


class CircuitBreaker:
    """Trip-to-dense / re-arm-after-quiet controller over overflow-drain
    pressure. ``observe(overflow_events, dispatches)`` is called once per
    health interval and returns the action to take: ``"trip"`` (pressure
    rate exceeded ``trip_threshold`` while armed), ``"rearm"``
    (``rearm_after`` consecutive quiet intervals while tripped), or None.
    Transitions land in :attr:`log` as ``(interval_idx, action, rate)``."""

    def __init__(self, trip_threshold: float = 0.25,
                 rearm_threshold: float = 0.0,
                 rearm_after: int = 3):
        self.trip_threshold = float(trip_threshold)
        self.rearm_threshold = float(rearm_threshold)
        self.rearm_after = int(rearm_after)
        self.tripped = False
        self._quiet = 0
        self._interval = 0
        self.log: List[Tuple[int, str, float]] = []

    def observe(self, overflow_events: int, dispatches: int) -> Optional[str]:
        self._interval += 1
        rate = overflow_events / max(dispatches, 1)
        if not self.tripped:
            if rate > self.trip_threshold:
                self.tripped = True
                self._quiet = 0
                self.log.append((self._interval, "trip", rate))
                return "trip"
            return None
        if rate <= self.rearm_threshold:
            self._quiet += 1
            if self._quiet >= self.rearm_after:
                self.tripped = False
                self._quiet = 0
                self.log.append((self._interval, "rearm", rate))
                return "rearm"
        else:
            self._quiet = 0
        return None


@dataclasses.dataclass
class Recovery:
    """One crash → restore → replay cycle's measurements."""

    restart: int
    restored_step: Optional[int]
    restored_wal_lsn: int
    replayed_events: int
    replayed_records: int
    recovery_s: float
    replay_eps: float


class ServiceSupervisor:
    """Crash-supervised, WAL-backed driver for a persistent-query service.

    ``make_service`` builds a FRESH, fully registered service; it must
    accept keyword overrides forwarded to
    :class:`~repro_torch.streaming.service.PersistentQueryService` (the circuit
    breaker rebuilds through it with :data:`DENSE_FALLBACK_OVERRIDES`).
    Determinism contract: ``make_service`` must be pure (same overrides →
    an identically configured service with the same registrations), and
    the service must not enable ``adaptive_batch`` when ``verify_replay``
    is on — adaptive sizing regroups micro-batches from counters a
    restored run cannot reproduce, which voids per-event identity (the
    documented B > 1 batch-boundary skew).
    """

    def __init__(self, make_service: Callable[..., object],
                 ckpt_dir: str,
                 wal_dir: Optional[str] = None,
                 *,
                 batch_events: int = 8,
                 ckpt_every: int = 4,
                 health_every: int = 4,
                 max_restarts: int = 16,
                 max_retries: int = 3,
                 backoff_s: float = 0.0,
                 fault_plan: Optional[FaultPlan] = None,
                 monitor: Optional[object] = None,
                 on_straggler: Optional[Callable[[int], None]] = None,
                 queue_cap: int = 4096,
                 queue_policy: str = "block",
                 drain_batches: int = 2,
                 breaker: Optional[CircuitBreaker] = None,
                 degraded_overrides: Optional[Dict[str, object]] = None,
                 verify_replay: bool = True,
                 segment_records: int = 64):
        from ..distributed.fault import StragglerMonitor

        self.make_service = make_service
        self.ckpt_dir = ckpt_dir
        self.wal = WriteAheadLog(wal_dir or f"{ckpt_dir}/wal",
                                 segment_records=segment_records)
        self.batch_events = max(1, int(batch_events))
        self.ckpt_every = max(1, int(ckpt_every))
        self.health_every = max(1, int(health_every))
        self.max_restarts = int(max_restarts)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.plan = fault_plan
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self.on_straggler = on_straggler
        self.queue = BoundedIngestQueue(queue_cap, queue_policy)
        self.drain_batches = max(1, int(drain_batches))
        self.breaker = breaker
        self._degraded = dict(degraded_overrides or DENSE_FALLBACK_OVERRIDES)
        self.verify_replay = bool(verify_replay)

        #: per-lsn NEW results / invalidations — the durable result stream
        #: (replay fills gaps and, under verify_replay, re-proves matches)
        self.results_by_lsn: Dict[int, Dict[str, frozenset]] = {}
        self.invalidated_by_lsn: Dict[int, Dict[str, frozenset]] = {}
        #: (lsn, kind, name, meta) query-lifecycle history; persisted into
        #: every checkpoint so recovery can rebuild the exact query set
        #: even after the WAL prefix is truncated
        self.churn_history: List[Tuple[int, str, str, Dict]] = []
        self.health_log: List[Dict[str, object]] = []
        self.recoveries: List[Recovery] = []
        self.restarts = 0
        self.retries = 0
        self.stragglers: List[int] = []
        self.replaying = False

        self._overrides: Dict[str, object] = {}
        self._dispatches = 0
        self._snapshots = 0
        self._health_mark: Dict[str, int] = {}
        self._health_dispatch_mark = 0
        self._stragglers_mark = 0
        self._retries_mark = 0
        self.service = self._fresh_service()

    # -- service lifecycle ----------------------------------------------------

    def _fresh_service(self):
        svc = self.make_service(**self._overrides)
        self._health_mark = {}
        return svc

    def register(self, name: str, expr: str, **kwargs) -> None:
        """WAL-logged live registration (replayable mid-stream churn)."""
        lsn = self.wal.append_churn(
            "register", name, {"expr": expr, "kwargs": kwargs})
        self.churn_history.append(
            (lsn, "register", name, {"expr": expr, "kwargs": kwargs}))
        self.service.register(name, expr, **kwargs)

    def deregister(self, name: str) -> None:
        lsn = self.wal.append_churn("deregister", name)
        self.churn_history.append((lsn, "deregister", name, {}))
        self.service.deregister(name)

    def _apply_churn(self, kind: str, name: str, meta: Dict) -> None:
        if kind == "register":
            self.service.register(name, meta["expr"], **meta.get("kwargs", {}))
        else:
            self.service.deregister(name)

    # -- main loop ------------------------------------------------------------

    def run(self, stream, arrival_chunk: Optional[int] = None
            ) -> Dict[str, Set[Tuple]]:
        """Feed the whole stream under supervision; returns the final
        result sets per query. Arrivals enter in ``arrival_chunk``-sized
        waves (default: exactly the service's drain capacity, so the
        queue never overflows); each tick then drains at most
        ``drain_batches`` micro-batches — an arrival wave larger than
        that models a producer outpacing the service and exercises the
        queue policy."""
        capacity = self.batch_events * self.drain_batches
        chunk = capacity if arrival_chunk is None else max(1, arrival_chunk)
        events = iter(stream)
        exhausted = False
        while not exhausted or len(self.queue):
            wave = list(itertools.islice(events, chunk))
            exhausted = len(wave) < chunk
            for evt in wave:
                while not self.queue.push(evt):
                    # "block": the producer stalls until the service makes
                    # room — drain one batch inline, then re-offer
                    self._drain(1)
            self._drain(self.drain_batches)
        self._drain_all()
        ckpt.wait_pending(self.ckpt_dir)
        return self.results()

    def _drain(self, max_batches: int) -> None:
        for _ in range(max_batches):
            if not len(self.queue):
                return
            batch = self.queue.take(self.batch_events)
            self._process_batch(batch)

    def _drain_all(self) -> None:
        while len(self.queue):
            self._process_batch(self.queue.take(self.batch_events))

    def _process_batch(self, batch: List[SGT]) -> None:
        lsn = self.wal.append(batch)  # durable BEFORE the engine sees it
        try:
            self._dispatch(lsn, batch, replaying=False)
            self._after_dispatch_bookkeeping()
        except (InjectedCrash, SimulatedCrash):
            self._recover()

    def _after_dispatch_bookkeeping(self) -> None:
        self._dispatches += 1
        if self._dispatches % self.ckpt_every == 0:
            self._snapshot()
        if self._dispatches % self.health_every == 0:
            self._flush_health()

    # -- dispatch (fault hooks + bounded retry) -------------------------------

    def _dispatch(self, lsn: int, batch: List[SGT], replaying: bool) -> None:
        plan = self.plan
        hook = "during_replay" if replaying else "before_dispatch"
        if plan is not None:
            if plan.take_crash(hook, lsn):
                raise InjectedCrash(f"{hook} lsn={lsn}")
            delay = plan.take_sleep(lsn)
            if delay > 0:
                time.sleep(delay)  # straggler: observed below as wall time
        attempts = 0
        while True:
            t0 = time.monotonic()
            try:
                if plan is not None and plan.take_transient(lsn):
                    raise TransientDecodeError(f"transient at lsn={lsn}")
                report = self.service.ingest(batch)
                break
            except TransientDecodeError:
                attempts += 1
                self.retries += 1
                if attempts > self.max_retries:
                    raise
                if self.backoff_s > 0:
                    time.sleep(self.backoff_s * (2 ** (attempts - 1)))
        dt = time.monotonic() - t0
        if self.monitor.observe(self._dispatches, dt):
            self.stragglers.append(lsn)
            if self.on_straggler is not None:
                self.on_straggler(lsn)
        new = {name: frozenset(pairs) for name, pairs in report.items()}
        inv = {name: frozenset(pairs)
               for name, pairs in report.invalidated.items()}
        if replaying and self.verify_replay and lsn in self.results_by_lsn:
            if (self.results_by_lsn[lsn] != new
                    or self.invalidated_by_lsn[lsn] != inv):
                raise ReplayDivergence(
                    f"replayed lsn={lsn} diverged from the recorded "
                    f"result stream")
        self.results_by_lsn[lsn] = new
        self.invalidated_by_lsn[lsn] = inv
        if plan is not None and not replaying \
                and plan.take_crash("after_dispatch", lsn):
            raise InjectedCrash(f"after_dispatch lsn={lsn}")

    # -- snapshots ------------------------------------------------------------

    def _snapshot(self) -> None:
        """Async checkpoint at the current WAL position, then truncate the
        WAL below the last COMMITTED snapshot (never the in-flight one —
        a crash before its commit must still find the events it covers)."""
        self._snapshots += 1
        stage = (self.plan.take_snapshot_crash(self._snapshots)
                 if self.plan is not None else None)
        self.service.snapshot(
            self.ckpt_dir, step=self._dispatches,
            wal_lsn=self.wal.last_lsn,
            extra_meta={"churn": [list(c) for c in self.churn_history]},
            async_save=True, _crash_after=stage)
        if stage is not None:
            # the "process" died somewhere inside the save (the background
            # thread left exactly the partial state a kill would)
            raise InjectedCrash(f"mid-snapshot #{self._snapshots} ({stage})")
        committed = self._committed_wal_lsn()
        if committed is not None:
            self.wal.truncate_upto(committed)

    def _committed_wal_lsn(self) -> Optional[int]:
        try:
            extra = ckpt.manifest_extra(self.ckpt_dir)
        except FileNotFoundError:
            return None
        lsn = extra.get("wal_lsn")
        return int(lsn) if lsn is not None else None

    # -- crash recovery -------------------------------------------------------

    def _recover(self) -> None:
        """Restore the latest committed checkpoint and replay the WAL
        suffix; loops until a replay completes without a further injected
        crash (each attempt counts against ``max_restarts``)."""
        while True:
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise RuntimeError(
                    f"gave up after {self.max_restarts} restarts")
            try:
                self._rebuild_and_replay()
                return
            except (InjectedCrash, SimulatedCrash):
                continue

    def _rebuild_and_replay(self) -> None:
        t0 = time.monotonic()
        # a kill can land with an async save still "in flight" in-process;
        # a real kill would have destroyed the thread — joining here only
        # makes the test double deterministic, it never commits a save the
        # crash staged to abort (SimulatedCrash aborts inside save())
        ckpt.wait_pending(self.ckpt_dir)
        extra = None
        try:
            extra = ckpt.manifest_extra(self.ckpt_dir)
        except FileNotFoundError:
            pass
        self.replaying = True
        try:
            self.service = self._fresh_service()
            restored_step: Optional[int] = None
            ckpt_lsn = 0
            if extra is not None:
                # the checkpointed query set may differ from make_service's
                # base registrations (mid-stream churn): re-apply the
                # churn catalog the snapshot carried BEFORE restoring
                churn = [tuple(c) for c in extra.get("churn", [])]
                for _lsn, kind, name, meta in churn:
                    self._apply_churn(kind, name, dict(meta))
                self.churn_history = [
                    (int(lsn), kind, name, dict(meta))
                    for lsn, kind, name, meta in churn]
                restored_step = self.service.restore(self.ckpt_dir)
                ckpt_lsn = int(extra.get("wal_lsn", 0))
            else:
                self.churn_history = []
            n_events = n_records = 0
            for rec in self.wal.replay(after_lsn=ckpt_lsn):
                n_records += 1
                if rec.kind == "batch":
                    n_events += len(rec.events)
                    self._dispatch(rec.lsn, list(rec.events), replaying=True)
                else:
                    self._apply_churn(rec.kind, rec.meta["name"],
                                      {k: v for k, v in rec.meta.items()
                                       if k != "name"})
                    self.churn_history.append(
                        (rec.lsn, rec.kind, rec.meta["name"],
                         {k: v for k, v in rec.meta.items() if k != "name"}))
        finally:
            self.replaying = False
        dt = time.monotonic() - t0
        self.recoveries.append(Recovery(
            restart=self.restarts, restored_step=restored_step,
            restored_wal_lsn=ckpt_lsn, replayed_events=n_events,
            replayed_records=n_records, recovery_s=dt,
            replay_eps=(n_events / dt) if dt > 0 else float("inf")))

    # -- health / degradation -------------------------------------------------

    def _overflow_counters(self) -> Dict[str, int]:
        """Current cumulative overflow-drain counters of the live service
        (all host-known ints; the stats properties never sync the device
        stream beyond their own documented flush)."""
        svc = self.service
        group = getattr(svc, "_group", None)
        if group is None:
            return {}
        ex = group.executor
        out = {"frontier_fallbacks": int(
            ex.frontier_stats.get("fallbacks", 0))}
        astats = ex.adjacency_stats
        out["adj_spill_drains"] = int(astats.get("spill_drains", 0))
        out["adj_repacks"] = int(astats.get("repacks", 0))
        dstats = ex.dist_stats
        out["dist_drains"] = int(dstats.get("drains", 0))
        out["dist_repacks"] = int(dstats.get("repacks", 0))
        return out

    def _flush_health(self) -> None:
        """Per-interval telemetry flush: overflow-drain deltas, queue
        pressure, stragglers, retries → :attr:`health_log`; feeds the
        circuit breaker and triggers trip/re-arm handovers. This is the
        supervisor's sanctioned counter-flush site (analyzer rule R5)."""
        cur = self._overflow_counters()
        overflow = sum(v - self._health_mark.get(k, 0)
                       for k, v in cur.items())
        self._health_mark = cur
        dispatches = self._dispatches - self._health_dispatch_mark
        self._health_dispatch_mark = self._dispatches
        entry: Dict[str, object] = {
            "dispatches_total": self._dispatches,
            "interval_dispatches": dispatches,
            "wal_lsn": self.wal.last_lsn,
            "queue_depth": len(self.queue),
            "queue_high_water": self.queue.high_water,
            "shed": self.queue.shed,
            "blocked": self.queue.blocked,
            "stragglers": len(self.stragglers) - self._stragglers_mark,
            "retries": self.retries - self._retries_mark,
            "overflow_events": overflow,
            "overflow_rate": overflow / max(dispatches, 1),
            "restarts": self.restarts,
            "degraded": bool(self._overrides),
        }
        self._stragglers_mark = len(self.stragglers)
        self._retries_mark = self.retries
        action = None
        if self.breaker is not None:
            action = self.breaker.observe(overflow, dispatches)
            entry["breaker"] = ("tripped" if self.breaker.tripped
                                else "armed")
        self.health_log.append(entry)
        if action == "trip":
            self._reconfigure(self._degraded)
        elif action == "rearm":
            self._reconfigure({})

    def _reconfigure(self, overrides: Dict[str, object]) -> None:
        """Controlled handover onto a different service configuration:
        sync snapshot at the current WAL position, rebuild with the
        overrides, restore — loss-free (canonical-dense checkpoints
        restore across layouts/executors), and no replay is needed
        because the snapshot is current."""
        self._snapshots += 1
        self.service.snapshot(
            self.ckpt_dir, step=self._dispatches,
            wal_lsn=self.wal.last_lsn,
            extra_meta={"churn": [list(c) for c in self.churn_history]},
            async_save=False)
        self._overrides = dict(overrides)
        self.service = self._fresh_service()
        for _lsn, kind, name, meta in self.churn_history:
            self._apply_churn(kind, name, dict(meta))
        self.service.restore(self.ckpt_dir)
        committed = self._committed_wal_lsn()
        if committed is not None:
            self.wal.truncate_upto(committed)

    # -- reporting ------------------------------------------------------------

    def results(self) -> Dict[str, Set[Tuple]]:
        """Final monotone result sets per query, from the live service."""
        return {name: self.service.results(name)
                for name in self.service.queries}

    def result_stream(self) -> List[Tuple[int, Dict[str, frozenset]]]:
        """The per-batch NEW-result stream in lsn order — the object the
        replay-identity contract is about."""
        return sorted(self.results_by_lsn.items())

    def invalidation_stream(self) -> List[Tuple[int, Dict[str, frozenset]]]:
        return sorted(self.invalidated_by_lsn.items())
