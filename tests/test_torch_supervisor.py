"""The port's supervision layer (``repro_torch.streaming.wal``,
``.supervisor`` and ``repro_torch.distributed.fault``) on the CPU: the
reference's cases of tests/test_supervisor.py on the ``local-dense`` and
``local-sparse`` configurations (WAL durability, crash-recovery identity at
every fault point, backpressure, circuit-breaker degradation), and
tests/test_substrates.py's restart loop and straggler monitor on a dict of
tensors; then against the JAX package: the two WALs write the same bytes,
a WAL either package wrote replays in the other with per-lsn identity, and
the port's chaos run gives the JAX package's clean result stream.

Nothing here depends on wall-clock time: the circuit breaker decides from
overflow counters, and the straggler leg feeds its monitor fixed
durations. Tolerance 0 throughout.
"""
import os
import tempfile

import pytest
import torch

from repro.streaming.service import PersistentQueryService as JaxService
from repro.streaming.stream import SGT as JaxSGT
from repro.streaming.supervisor import ServiceSupervisor as JaxSupervisor
from repro.streaming.wal import WriteAheadLog as JaxWAL
from repro_torch.distributed.fault import (StragglerMonitor, run_service_with_restarts,
                                           run_with_restarts)
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import SGT
from repro_torch.streaming.supervisor import (DENSE_FALLBACK_OVERRIDES,
                                              BoundedIngestQueue, CircuitBreaker,
                                              FaultPlan, ServiceSupervisor)
from repro_torch.streaming.wal import WriteAheadLog

WINDOW, SLIDE = 20.0, 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many tiny tensor ops; with one intra-op thread per
    process they do not spin-wait against the other test workers for the
    cores (under ``-n 6`` they ran up to 100x slower with the default)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _register(svc):
    svc.register("d_arb", "a2q . c2a*", engine="dense", n_slots=48)
    svc.register("d_plus", "(a2q | c2a)+", engine="dense", n_slots=48)
    svc.register("r_arb", "a2q . c2a*", engine="reference")
    return svc


def _make_service(**overrides):
    kw = dict(window=WINDOW, slide=SLIDE, device="cpu")
    kw.update(overrides)
    return _register(PersistentQueryService(**kw))


def _make_jax(**overrides):
    return _register(JaxService(window=WINDOW, slide=SLIDE, **overrides))


def _stream_tuples():
    return list(with_deletions(so_like(24, 110, seed=13), ratio=0.04, seed=7))


def _jax_tuples(tuples):
    return [JaxSGT(s.ts, s.src, s.dst, s.label, s.op) for s in tuples]


def _clean_run(tuples, make_service, **sup_kwargs):
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(make_service, d, **sup_kwargs)
        final = sup.run(list(tuples))
        return final, sup.result_stream(), sup.invalidation_stream()


# -- WAL ------------------------------------------------------------------------


def _mixed_batch(ts0, sgt=SGT):
    # vertex ids across types: int, str, tuple
    return [sgt(ts0, 1, 2, "a2q"),
            sgt(ts0 + 0.1, "s1", ("p", 3), "c2a"),
            sgt(ts0 + 0.2, ("m", 4), 7, "c2q", "-")]


def test_wal_round_trip_typed_vertices():
    with tempfile.TemporaryDirectory() as d:
        wal = WriteAheadLog(d)
        b1, b2 = _mixed_batch(1.0), _mixed_batch(2.0)
        assert wal.append(b1) == 1
        assert wal.append(b2) == 2
        recs = list(wal.replay())
        assert [r.lsn for r in recs] == [1, 2]
        assert list(recs[0].events) == b1
        assert list(recs[1].events) == b2
        assert recs[0].clock == pytest.approx(1.2)
        wal.close()
        wal2 = WriteAheadLog(d)
        assert wal2.last_lsn == 2
        assert wal2.append(_mixed_batch(3.0)) == 3
        assert [r.lsn for r in wal2.replay(after_lsn=1)] == [2, 3]


def test_wal_refuses_empty_batch():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError):
            WriteAheadLog(d).append([])


def test_wal_torn_tail_is_skipped_and_truncated():
    with tempfile.TemporaryDirectory() as d:
        wal = WriteAheadLog(d)
        for i in range(3):
            wal.append(_mixed_batch(float(i)))
        wal.close()
        seg = os.path.join(d, wal._segments()[-1])
        size = os.path.getsize(seg)
        with open(seg, "r+b") as f:     # tear the last record mid-write
            f.truncate(size - 7)
        wal2 = WriteAheadLog(d)
        assert wal2.torn_records == 1
        assert wal2.last_lsn == 2
        assert wal2.append(_mixed_batch(9.0)) == 3
        assert [r.lsn for r in wal2.replay()] == [1, 2, 3]
        assert list(list(wal2.replay())[-1].events) == _mixed_batch(9.0)


def test_wal_crc_rejects_corruption():
    with tempfile.TemporaryDirectory() as d:
        wal = WriteAheadLog(d)
        wal.append(_mixed_batch(1.0))
        wal.append(_mixed_batch(2.0))
        wal.close()
        seg = os.path.join(d, wal._segments()[0])
        with open(seg, "rb") as f:
            blob = f.read()
        corrupted = blob[:20] + bytes([blob[20] ^ 0xFF]) + blob[21:]
        with open(seg, "wb") as f:
            f.write(corrupted)
        wal2 = WriteAheadLog(d)
        assert list(wal2.replay()) == []
        assert wal2.torn_records >= 1


def test_wal_rotation_and_truncate_upto():
    with tempfile.TemporaryDirectory() as d:
        wal = WriteAheadLog(d, segment_records=4)
        for i in range(10):
            wal.append(_mixed_batch(float(i)))
        assert len(wal._segments()) == 3
        assert wal.truncate_upto(8) == 2
        assert [r.lsn for r in wal.replay()] == [9, 10]
        assert wal.truncate_upto(10) == 0
        assert [r.lsn for r in wal.replay(after_lsn=9)] == [10]


def test_wal_churn_records_ride_the_sequence():
    with tempfile.TemporaryDirectory() as d:
        wal = WriteAheadLog(d)
        wal.append(_mixed_batch(1.0))
        wal.append_churn("register", "q_new",
                         {"expr": "a2q+", "kwargs": {"engine": "dense"}})
        wal.append(_mixed_batch(2.0))
        wal.append_churn("deregister", "q_new")
        kinds = [(r.lsn, r.kind) for r in wal.replay()]
        assert kinds == [(1, "batch"), (2, "register"),
                         (3, "batch"), (4, "deregister")]
        reg = list(wal.replay())[1]
        assert reg.meta == {"name": "q_new", "expr": "a2q+",
                            "kwargs": {"engine": "dense"}}
        with pytest.raises(ValueError):
            wal.append_churn("rename", "q_new")


# -- fault plan / queue / breaker -----------------------------------------------


def test_fault_plan_fires_exactly_once():
    plan = FaultPlan(crash_before_dispatch=[3], crash_mid_snapshot={1: "rename"},
                     slow_dispatch={2: 0.5}, transient_errors={4: 2})
    assert plan.take_crash("before_dispatch", 3)
    assert not plan.take_crash("before_dispatch", 3)
    assert plan.take_snapshot_crash(1) == "rename"
    assert plan.take_snapshot_crash(1) is None
    assert plan.take_sleep(2) == 0.5
    assert plan.take_sleep(2) == 0.0
    assert plan.take_transient(4) and plan.take_transient(4)
    assert not plan.take_transient(4)
    assert plan.exhausted


def test_fault_plan_chaos_is_deterministic():
    a = FaultPlan.chaos(seed=11, n_batches=200, snapshot_crash_every=5)
    b = FaultPlan.chaos(seed=11, n_batches=200, snapshot_crash_every=5)
    assert a.__dict__ == b.__dict__
    c = FaultPlan.chaos(seed=12, n_batches=200)
    assert a.__dict__ != c.__dict__
    with pytest.raises(ValueError):
        FaultPlan(crash_mid_snapshot={1: "nonsense"})


def test_bounded_queue_policies():
    evt = [SGT(float(i), i, i + 1, "a2q") for i in range(8)]
    q = BoundedIngestQueue(cap=3, policy="block")
    assert all(q.push(e) for e in evt[:3])
    assert not q.push(evt[3])
    assert q.blocked == 1 and q.shed == 0
    q.take(1)
    assert q.push(evt[3])

    q = BoundedIngestQueue(cap=3, policy="shed-oldest")
    for e in evt[:5]:
        assert q.push(e)
    assert q.shed == 2
    assert [s.src for s in q.take(3)] == [2, 3, 4]

    q = BoundedIngestQueue(cap=3, policy="shed-newest")
    for e in evt[:5]:
        assert q.push(e)
    assert q.shed == 2
    assert [s.src for s in q.take(3)] == [0, 1, 2]

    with pytest.raises(ValueError):
        BoundedIngestQueue(cap=0)
    with pytest.raises(ValueError):
        BoundedIngestQueue(cap=1, policy="random-early-drop")


def test_circuit_breaker_trip_and_rearm():
    br = CircuitBreaker(trip_threshold=0.25, rearm_after=2)
    assert br.observe(1, 10) is None
    assert br.observe(5, 10) == "trip"
    assert br.tripped
    assert br.observe(0, 10) is None
    assert br.observe(3, 10) is None
    assert br.observe(0, 10) is None
    assert br.observe(0, 10) == "rearm"
    assert not br.tripped
    assert [a for _i, a, _r in br.log] == ["trip", "rearm"]


# -- crash-recovery identity -----------------------------------------------------

CONFIGS = {
    "local-dense": {},
    "local-sparse": dict(frontier="on", frontier_cap=16, adj_layout="ell",
                         ell_cap=6, dist_layout="row_sparse", dist_cap=24),
}

#: every fault point: crash before and after dispatch, mid-snapshot at each
#: stage of the commit protocol, during the recovery replay, a straggler
#: and a transient error with retry
ALL_FAULT_POINTS = dict(
    crash_before_dispatch=[3], crash_after_dispatch=[7],
    crash_during_replay=[9],
    crash_mid_snapshot={1: "shards", 2: "manifest", 3: "rename"},
    slow_dispatch={5: 0.001}, transient_errors={6: 2})


@pytest.mark.parametrize("cfg_key", sorted(CONFIGS))
def test_crash_recovery_identity_all_fault_points(cfg_key):
    overrides = CONFIGS[cfg_key]

    def make(**extra):
        kw = dict(overrides)
        kw.update(extra)
        return _make_service(**kw)

    tuples = _stream_tuples()
    clean_final, clean_stream, clean_inval = _clean_run(
        tuples, make, batch_events=8, ckpt_every=4)

    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(**ALL_FAULT_POINTS)
        sup = ServiceSupervisor(make, d, batch_events=8, ckpt_every=4,
                                fault_plan=plan, verify_replay=True)
        chaos_final = sup.run(list(tuples))
        assert plan.exhausted, "every scheduled fault must have fired"
        assert sup.restarts >= 4
        assert sup.recoveries
        assert sup.retries >= 2
        assert sup.result_stream() == clean_stream
        assert sup.invalidation_stream() == clean_inval
        assert chaos_final == clean_final
        for r in sup.recoveries:
            assert r.recovery_s >= 0.0
            assert r.replayed_events >= 0


def test_seeded_chaos_matrix_identity():
    tuples = _stream_tuples()
    clean_final, clean_stream, _ = _clean_run(
        tuples, _make_service, batch_events=8, ckpt_every=4)
    for seed in (0, 1):
        with tempfile.TemporaryDirectory() as d:
            plan = FaultPlan.chaos(seed=seed, n_batches=14, crash_rate=0.2,
                                   transient_rate=0.2, straggler_s=0.0005)
            sup = ServiceSupervisor(_make_service, d, batch_events=8,
                                    ckpt_every=4, fault_plan=plan)
            assert sup.run(list(tuples)) == clean_final, seed
            assert sup.result_stream() == clean_stream, seed


def test_recovery_with_query_churn_in_wal():
    tuples = _stream_tuples()

    def drive(sup):
        sup.run(list(tuples[:40]))
        sup.register("late", "c2a . a2q*", engine="dense", n_slots=48)
        sup.run(list(tuples[40:80]))
        sup.deregister("d_plus")
        sup.run(list(tuples[80:]))
        return sup.results()

    with tempfile.TemporaryDirectory() as d:
        clean = drive(ServiceSupervisor(_make_service, d, batch_events=8,
                                        ckpt_every=4))
    with tempfile.TemporaryDirectory() as d:
        # lsn 6 / 12 are the churn records; 7 and 13 the first batches
        # dispatched after each churn op
        plan = FaultPlan(crash_before_dispatch=[7, 13],
                         crash_mid_snapshot={2: "rename"})
        sup = ServiceSupervisor(_make_service, d, batch_events=8,
                                ckpt_every=4, fault_plan=plan)
        chaos = drive(sup)
        assert plan.exhausted
        assert sup.restarts >= 3
    assert set(chaos) == set(clean)
    assert "late" in chaos and "d_plus" not in chaos
    for name in clean:
        assert chaos[name] == clean[name], name


def test_supervisor_gives_up_after_max_restarts():
    tuples = _stream_tuples()[:40]
    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(crash_before_dispatch=[2, 3, 4, 5])
        sup = ServiceSupervisor(_make_service, d, batch_events=8,
                                ckpt_every=4, fault_plan=plan,
                                max_restarts=2)
        with pytest.raises(RuntimeError, match="restarts"):
            sup.run(list(tuples))


# -- backpressure ------------------------------------------------------------------


def test_backpressure_block_policy_loses_nothing():
    tuples = _stream_tuples()
    clean_final, clean_stream, _ = _clean_run(
        tuples, _make_service, batch_events=8, ckpt_every=4)
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(_make_service, d, batch_events=8,
                                ckpt_every=4, queue_cap=4,
                                queue_policy="block")
        final = sup.run(list(tuples), arrival_chunk=64)
        assert sup.queue.blocked > 0
        assert sup.queue.shed == 0
        assert sup.queue.accepted == len(tuples)
        assert final == clean_final
        assert sup.wal.last_lsn >= len(clean_stream)


def test_backpressure_shed_policy_drops_explicitly():
    tuples = _stream_tuples()
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(_make_service, d, batch_events=8,
                                ckpt_every=4, queue_cap=8,
                                queue_policy="shed-oldest", drain_batches=1)
        sup.run(list(tuples), arrival_chunk=len(tuples))
        assert sup.queue.shed > 0
        assert sup.queue.high_water == 8
        # shed events never reached the WAL: it holds exactly what was
        # accepted and drained
        logged = sum(len(r.events) for r in sup.wal.replay())
        assert logged + sup.queue.shed == len(tuples)


# -- circuit breaker / graceful degradation ------------------------------------------


def _overflowy_service(**overrides):
    # capacities small enough that so_like's cyclic core overflows the
    # frontier, the ELL rows and the row-sparse dist rows
    kw = dict(window=WINDOW, slide=SLIDE, frontier="on", frontier_cap=2,
              adj_layout="ell", ell_cap=2, dist_layout="row_sparse",
              dist_cap=4, device="cpu")
    kw.update(overrides)
    svc = PersistentQueryService(**kw)
    svc.register("d_arb", "a2q . c2a*", engine="dense", n_slots=48)
    svc.register("d_plus", "(a2q | c2a)+", engine="dense", n_slots=48)
    return svc


def test_breaker_trips_to_dense_and_preserves_results():
    tuples = _stream_tuples()
    clean_final, _, _ = _clean_run(tuples, _overflowy_service,
                                   batch_events=8, ckpt_every=4)
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(
            _overflowy_service, d, batch_events=8, ckpt_every=4,
            health_every=2,
            breaker=CircuitBreaker(trip_threshold=0.5, rearm_after=10_000))
        final = sup.run(list(tuples))
        assert sup.breaker.tripped
        assert [a for _i, a, _r in sup.breaker.log] == ["trip"]
        assert sup._overrides == DENSE_FALLBACK_OVERRIDES
        ex = sup.service._group.executor
        assert ex.adjacency_stats["layout"] == "dense"
        assert ex.dist_stats["layout"] == "dense"
        assert sup.service._frontier == "off"
        assert final == clean_final
        assert any(h.get("degraded") for h in sup.health_log)


def test_breaker_rearms_after_quiet_period():
    """Decided from the overflow counters alone (no clock)."""
    tuples = _stream_tuples()
    clean_final, _, _ = _clean_run(tuples, _overflowy_service,
                                   batch_events=8, ckpt_every=4)
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(
            _overflowy_service, d, batch_events=8, ckpt_every=4,
            health_every=2,
            breaker=CircuitBreaker(trip_threshold=0.5, rearm_after=1))
        final = sup.run(list(tuples))
        actions = [a for _i, a, _r in sup.breaker.log]
        assert actions[0] == "trip"
        assert "rearm" in actions
        assert final == clean_final
        marks = [h["breaker"] for h in sup.health_log]
        assert "tripped" in marks and "armed" in marks
        # each decision is the counters' rate against the threshold
        for h in sup.health_log:
            assert h["overflow_rate"] == \
                h["overflow_events"] / max(h["interval_dispatches"], 1)


# -- the restart loops (tests/test_substrates.py and run_service_with_restarts) -----


class FixedDurations(StragglerMonitor):
    """A straggler monitor fed a fixed duration per observation (the i-th
    dispatch it is shown takes ``slow_s`` if ``i`` is in ``slow``, else
    ``fast_s``), whatever the wall clock says."""

    def __init__(self, slow, fast_s=0.01, slow_s=1.0, **kw):
        super().__init__(**kw)
        self.slow, self.fast_s, self.slow_s = set(slow), fast_s, slow_s
        self.n_observed = 0

    def observe(self, step, dt):
        i, self.n_observed = self.n_observed, self.n_observed + 1
        return super().observe(step, self.slow_s if i in self.slow else self.fast_s)


def test_run_service_with_restarts_port():
    tuples = _stream_tuples()
    clean_final, _, _ = _clean_run(tuples, _make_service,
                                   batch_events=8, ckpt_every=4)
    slow_lsns = []
    monitor = FixedDurations(slow={8, 11}, deadline_factor=3.0, warmup=5)
    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(crash_before_dispatch=[4])
        results, report = run_service_with_restarts(
            _make_service, list(tuples), d,
            batch_events=8, ckpt_every=4, fault_plan=plan,
            on_straggler=slow_lsns.append, monitor=monitor)
        assert results == clean_final
        assert report["restarts"] == 1
        assert report["final_step"] == 14
        assert report["recoveries"] and report["recoveries"][0]["replay_eps"] > 0
        # observations 0-2 are lsn 1-3, 3-6 the replay of lsn 1-4 after the
        # crash, 7-16 lsn 5-14; the monitor's steps count live dispatches
        assert report["stragglers"] == slow_lsns == [6, 9]
        assert monitor.stragglers == [4, 7]
        assert sum(h["stragglers"] for h in report["health_log"]) == 2


def test_run_with_restarts_recovers_from_crash():
    crashed = {"done": False}

    def step_fn(state, step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1.0, "n": state["n"] + 1}

    with tempfile.TemporaryDirectory() as d:
        init = {"x": torch.zeros(()), "n": torch.zeros((3,), dtype=torch.int32)}
        final, info = run_with_restarts(step_fn, init, n_steps=12, ckpt_dir=d,
                                        ckpt_every=5)
        assert info["restarts"] == 1
        assert info["final_step"] == 12
        assert float(final["x"]) == 12.0   # exactly once, via the resume
        assert final["n"].dtype == torch.int32 and final["n"].tolist() == [12] * 3


def test_straggler_monitor():
    mon = StragglerMonitor(deadline_factor=3.0, warmup=3)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 1.0)
    assert not mon.observe(11, 0.12)
    assert mon.stragglers == [10]


# -- against the JAX package -----------------------------------------------------------


def test_the_two_wals_write_the_same_bytes():
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        for wal, sgt in ((JaxWAL(dj, segment_records=3), JaxSGT),
                         (WriteAheadLog(dt, segment_records=3), SGT)):
            for i in range(4):
                wal.append(_mixed_batch(float(i), sgt))
            wal.append_churn("register", "q", {"expr": "a2q+", "kwargs": {}})
            wal.append_churn("deregister", "q")
            wal.close()
        assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
        for name in os.listdir(dj):
            with open(os.path.join(dj, name), "rb") as fj, \
                    open(os.path.join(dt, name), "rb") as ft:
                assert fj.read() == ft.read(), name


@pytest.fixture(scope="module")
def jax_clean(tmp_path_factory):
    """The JAX package's clean supervised run (local-dense) and its WAL."""
    d = str(tmp_path_factory.mktemp("jax_sup"))
    sup = JaxSupervisor(_make_jax, d, batch_events=8, ckpt_every=4)
    final = sup.run(_jax_tuples(_stream_tuples()))
    return dict(dir=d, final=final, stream=sup.result_stream(),
                inval=sup.invalidation_stream())


def _replay_into(wal, svc):
    """Per-lsn (new, invalidated) of ``svc`` fed ``wal``'s batches."""
    out = {}
    for rec in wal.replay():
        rep = svc.ingest(list(rec.events))
        out[rec.lsn] = ({n: frozenset(p) for n, p in rep.items()},
                        {n: frozenset(p) for n, p in rep.invalidated.items()})
    return out


def test_jax_wal_replays_in_port_per_lsn(jax_clean):
    wal = WriteAheadLog(os.path.join(jax_clean["dir"], "wal"))
    got = _replay_into(wal, _make_service())
    assert sorted((lsn, new) for lsn, (new, _inv) in got.items()) == jax_clean["stream"]
    assert sorted((lsn, inv) for lsn, (_new, inv) in got.items()) == jax_clean["inval"]


def test_port_wal_replays_in_jax_per_lsn():
    with tempfile.TemporaryDirectory() as d:
        sup = ServiceSupervisor(_make_service, d, batch_events=8, ckpt_every=4)
        sup.run(_stream_tuples())
        got = _replay_into(JaxWAL(os.path.join(d, "wal")), _make_jax())
    assert sorted((lsn, new) for lsn, (new, _inv) in got.items()) == sup.result_stream()
    assert sorted((lsn, inv) for lsn, (_new, inv) in got.items()) == \
        sup.invalidation_stream()


def test_port_chaos_run_gives_the_jax_clean_stream(jax_clean):
    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(**ALL_FAULT_POINTS)
        sup = ServiceSupervisor(_make_service, d, batch_events=8, ckpt_every=4,
                                fault_plan=plan, verify_replay=True)
        final = sup.run(_stream_tuples())
        assert plan.exhausted and sup.restarts >= 4
    assert sup.result_stream() == jax_clean["stream"]
    assert sup.invalidation_stream() == jax_clean["inval"]
    assert final == jax_clean["final"]
