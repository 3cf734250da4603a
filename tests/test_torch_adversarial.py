"""The adversarial workload layer of tests/test_adversarial.py on the port:
the five generator contracts on the port's generators, each held tuple for
tuple to the JAX package's on the same arguments, and the four
adaptive-controller scenarios (bursty arrivals, a deletion storm, a query
churn storm, window scales over 100x) on the port's service (CPU) against
the JAX service: every ingest report, the results, ``frontier_log``,
``dist_log`` and ``batch_size_log`` equal, and the port's controllers
settle by the reference's criteria (``_assert_controllers_settle``)."""
import collections

import pytest
import torch

from repro.streaming import generators as jax_gen
from repro_torch.streaming.generators import (bursty_arrivals, churn_storm_plan,
                                              deletion_storm, mixed_window_streams,
                                              powerlaw_hotspot, so_like)

from _torch_twins import TwinService, rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread, so the test workers do
    not spin-wait against each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- generator contracts ------------------------------------------------------


def test_bursty_arrivals_contract():
    kw = dict(seed=3, flash_every=50, flash_len=16, flash_boost=50.0)
    a = list(bursty_arrivals(32, 200, **kw))
    assert rows(a) == rows(jax_gen.bursty_arrivals(32, 200, **kw))
    assert a == list(bursty_arrivals(32, 200, **kw))
    assert a != list(bursty_arrivals(32, 200, seed=4, flash_every=50))
    assert len(a) == 200
    assert all(x.ts < y.ts for x, y in zip(a, a[1:]))
    gaps = [y.ts - x.ts for x, y in zip(a, a[1:])]
    flash = sorted(gaps)[:16]
    assert max(flash) < sorted(gaps)[len(gaps) // 2] / 2


def test_powerlaw_hotspot_contract():
    a = list(powerlaw_hotspot(64, 300, seed=3, alpha=1.2))
    assert rows(a) == rows(jax_gen.powerlaw_hotspot(64, 300, seed=3, alpha=1.2))
    assert a == list(powerlaw_hotspot(64, 300, seed=3, alpha=1.2))
    assert len(a) == 300
    assert all(x.ts < y.ts for x, y in zip(a, a[1:]))
    counts = collections.Counter(s.src for s in a)
    assert counts.most_common(1)[0][1] / len(a) > 10.0 / 64


def test_deletion_storm_contract():
    storm = list(deletion_storm(so_like(24, 150, seed=5), storm_every=40,
                                storm_len=16, seed=5))
    assert rows(storm) == rows(jax_gen.deletion_storm(
        jax_gen.so_like(24, 150, seed=5), storm_every=40, storm_len=16, seed=5))
    assert storm == list(deletion_storm(so_like(24, 150, seed=5),
                                        storm_every=40, storm_len=16, seed=5))
    assert all(x.ts < y.ts for x, y in zip(storm, storm[1:]))
    live = set()
    n_del = 0
    for s in storm:
        key = (s.src, s.dst, s.label)
        if s.op == "+":
            live.add(key)
        else:
            n_del += 1
            assert key in live
            live.discard(key)
    assert n_del >= 0.15 * 150


def test_mixed_window_streams_span_100x():
    entries = mixed_window_streams(24, 60, seed=1)
    ref = jax_gen.mixed_window_streams(24, 60, seed=1)
    assert [(e["name"], e["window"], e["slide"], rows(e["stream"])) for e in entries] \
        == [(e["name"], e["window"], e["slide"], rows(e["stream"])) for e in ref]
    windows = [e["window"] for e in entries]
    assert max(windows) / min(windows) == pytest.approx(100.0)
    for e in entries:
        assert 0 < e["slide"] <= e["window"]
        assert len(list(e["stream"])) == 60


def test_churn_storm_plan_contract():
    plan = churn_storm_plan(80, seed=2, churn_every=8)
    assert plan == jax_gen.churn_storm_plan(80, seed=2, churn_every=8)
    assert plan == churn_storm_plan(80, seed=2, churn_every=8)
    live = set()
    for batch_idx, op, name, kind, expr in plan:
        assert 0 < batch_idx < 80
        if op == "register":
            assert name not in live and kind in ("rpq", "rapq") and expr
            live.add(name)
        else:
            assert op == "deregister" and name in live
            live.discard(name)
    assert len(plan) >= 80 // 8 - 1


# -- adaptive-controller stability --------------------------------------------

WINDOW, SLIDE = 20.0, 2.0
ADAPTIVE = dict(adaptive_batch=True, frontier="auto", frontier_cap=8,
                dist_layout="row_sparse", dist_cap=16)


def _adaptive_service():
    svc = TwinService(WINDOW, SLIDE, max_batch=16, **ADAPTIVE)
    svc.register("q_arb", "a2q . c2a*", engine="dense", n_slots=48)
    svc.register("q_plus", "(a2q | c2a)+", engine="dense", n_slots=48)
    return svc


def _assert_controllers_settle(svc, regime):
    """The reference's stability criteria, on the port's service."""
    sizes = [b for _seen, b in svc.batch_size_log]
    for b in sizes:
        assert 1 <= b <= svc._max_batch and (b & (b - 1)) == 0, regime
    flips = sum(1 for i in range(2, len(sizes))
                if (sizes[i] - sizes[i - 1]) * (sizes[i - 1] - sizes[i - 2]) < 0)
    assert flips <= 2, (regime, sizes)

    caps = [e[1]["cap"] for e in svc.frontier_log if e[1].get("cap")]
    assert all(x <= y for x, y in zip(caps, caps[1:])), (regime, caps)
    if caps:
        assert caps[-1] <= caps[0] * 2 ** 4, (regime, caps)

    assert all(e[1]["lost"] == 0 for e in svc.dist_log), regime
    drains = [e[1]["drains"] for e in svc.dist_log]
    deltas = [y - x for x, y in zip(drains, drains[1:])]
    if len(deltas) >= 3:
        tail = deltas[-(len(deltas) // 3):]
        assert max(tail) <= max(deltas), regime
        assert all(d >= 0 for d in deltas), regime


def test_stability_under_bursty_arrivals():
    svc = _adaptive_service()
    svc.ingest(rows(bursty_arrivals(32, 260, seed=3, flash_every=60,
                                    flash_len=20, flash_boost=40.0)))
    svc.assert_equal()
    assert svc.port.frontier_log and svc.port.dist_log
    _assert_controllers_settle(svc.port, "bursty")


def test_stability_under_deletion_storm():
    svc = _adaptive_service()
    svc.ingest(rows(deletion_storm(so_like(24, 200, seed=5), storm_every=48,
                                   storm_len=20, seed=5)))
    svc.assert_equal()
    assert svc.port.dist_log
    _assert_controllers_settle(svc.port, "deletion-storm")


def test_stability_under_query_churn_storm():
    svc = _adaptive_service()
    tuples = list(powerlaw_hotspot(48, 240, seed=7, alpha=1.1))
    plan = churn_storm_plan(len(tuples) // 8, seed=2, churn_every=6)
    ops = {b * 8: (op, name, expr) for b, op, name, _kind, expr in plan}
    done = 0
    for cut in sorted(ops) + [len(tuples)]:
        if cut > done:
            svc.ingest(rows(tuples[done:cut]))
            done = cut
        if cut in ops:
            op, name, expr = ops[cut]
            if op == "register":
                svc.register(name, expr, engine="dense", n_slots=48)
            else:
                svc.deregister(name)
    svc.assert_equal()
    assert svc.port.dist_log
    _assert_controllers_settle(svc.port, "churn-storm")


def test_stability_across_window_scales():
    for entry in mixed_window_streams(24, 140, seed=1):
        svc = TwinService(entry["window"], entry["slide"], **ADAPTIVE)
        svc.register("q_arb", "a2q . c2a*", engine="dense", n_slots=48)
        svc.ingest(rows(entry["stream"]))
        svc.assert_equal()
        _assert_controllers_settle(svc.port, entry["name"])
