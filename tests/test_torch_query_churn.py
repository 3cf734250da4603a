"""Live query churn on the port against the JAX package: the ten scenarios
of tests/test_query_churn.py on the same seeds and streams, with the JAX
group (or service) and the port's (``device="cpu"``) driven side by side.
Every event's fresh results and invalidations, every registration's
initial answers, ``lane_of`` after each churn, ``q_cap`` and the label
axis, the executors' round totals and the checkpointed live query set
must be equal. Each scenario also keeps its own assertions on the port:
survivors against uninterrupted independent engines, late queries
against the port's ``make_churn_oracle``. A last case holds the port's
oracle to the JAX one on the same group history. Tolerance 0: max and min
never reassociate.
"""
import random
import tempfile

import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import RegisteredQuery as JaxQuery
from repro.core.engine import make_churn_oracle as jax_churn_oracle
from repro_torch.checkpoint import ckpt
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import (
    BatchedDenseRPQEngine,
    DenseRPQEngine,
    RegisteredQuery,
    make_churn_oracle,
)
from repro_torch.streaming.service import PersistentQueryService

from _torch_churn import DEREGISTER, LATE1, LATE2, QUERIES, churn_case, random_stream
from _torch_twins import TwinService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread, so the test workers do
    not spin-wait against each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class TwinGroup:
    """A JAX group and the port's group, built alike and driven alike:
    every call goes to both and must return the same; the port's answer is
    returned."""

    def __init__(self, queries, n_slots, batch_size=1):
        """``queries``: (name, expr, window[, path_semantics]) tuples."""
        self.jax = JaxEngine([self._jax_spec(*q) for q in queries],
                             n_slots=n_slots, batch_size=batch_size)
        self.port = BatchedDenseRPQEngine([self._port_spec(*q) for q in queries],
                                          n_slots=n_slots, batch_size=batch_size,
                                          device="cpu")

    @staticmethod
    def _jax_spec(name, expr, window, semantics="arbitrary"):
        return JaxQuery(name, jax_compile(expr), window, semantics)

    @staticmethod
    def _port_spec(name, expr, window, semantics="arbitrary"):
        return RegisteredQuery(name, compile_query(expr), window, semantics)

    def _both(self, method, *args):
        a = getattr(self.jax, method)(*args)
        b = getattr(self.port, method)(*args)
        assert a == b, (method, args)
        return b

    def insert(self, u, v, lab, ts):
        return self._both("insert", u, v, lab, ts)

    def delete(self, u, v, lab, ts):
        return self._both("delete", u, v, lab, ts)

    def expire(self, ts):
        self.jax.expire(ts)
        self.port.expire(ts)

    def current_results(self, lane):
        return self._both("current_results", lane)

    def register(self, name, expr, window, semantics="arbitrary"):
        """Both groups register the query: equal initial answers, lanes,
        lane capacity and label axis."""
        a = self.jax.register_query(self._jax_spec(name, expr, window, semantics))
        b = self.port.register_query(self._port_spec(name, expr, window, semantics))
        assert a == b, name
        self.assert_lanes_equal()
        return b

    def deregister(self, name):
        self.jax.deregister_query(name)
        self.port.deregister_query(name)
        self.assert_lanes_equal()

    def lane_of(self, name):
        return self._both("lane_of", name)

    def assert_lanes_equal(self):
        assert [s and s.name for s in self.port.lane_specs] == \
            [s and s.name for s in self.jax.lane_specs]
        for spec in self.port.query_specs:
            assert self.port.lane_of(spec.name) == self.jax.lane_of(spec.name)
        assert self.port.q_cap == self.jax.q_cap
        assert self.port.labels == self.jax.labels
        assert tuple(self.port.batched_arrays.adj.shape) == \
            tuple(self.jax.batched_arrays.adj.shape)
        assert tuple(self.port.batched_arrays.dist.shape) == \
            tuple(self.jax.batched_arrays.dist.shape)

    def assert_equal(self):
        """End state: results, lanes and every round total."""
        assert self.port.per_query_results == self.jax.per_query_results
        self.assert_lanes_equal()
        pe, je = self.port.executor, self.jax.executor
        assert (pe.rounds_total, pe.query_rounds_total,
                pe.unmasked_query_rounds_total) == \
            (je.rounds_total, je.query_rounds_total, je.unmasked_query_rounds_total)


def _oracle_for(expr, semantics, twin, window, n_slots):
    """The port's oracle for a late query; its seed is the registration's
    answer (checked by the caller)."""
    return make_churn_oracle(compile_query(expr), twin.port, window, n_slots,
                             path_semantics=semantics)


def _indep(expr, window, semantics="arbitrary"):
    return DenseRPQEngine(compile_query(expr), window, n_slots=16, batch_size=1,
                          path_semantics=semantics, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_register_mid_stream_matches_fresh_oracle(seed):
    rng = random.Random(seed)
    window = 15.0
    base = [("q0", "a . b*", window), ("q1", "(a | b)*", window)]
    group = TwinGroup(base, n_slots=16)
    indep = [_indep(e, window) for _n, e, _w in base]
    stream = random_stream(rng, 6, 30, 80)
    cut = 15
    for i, (u, v, lab, ts) in enumerate(stream[:cut]):
        fresh = group.insert(u, v, lab, ts)
        for qi, eng in enumerate(indep):
            assert fresh[qi] == eng.insert(u, v, lab, ts), (seed, i, qi)
        if i % 7 == 6:
            group.expire(ts)
            for eng in indep:
                eng.expire(ts)

    oracle, oseed = _oracle_for("a*", "arbitrary", group, window, 16)
    initial = group.register("late", "a*", window)
    lane = group.lane_of("late")
    assert initial == oseed, seed
    assert group.current_results(lane) == oracle.current_results()

    for i, (u, v, lab, ts) in enumerate(stream[cut:]):
        fresh = group.insert(u, v, lab, ts)
        assert fresh[lane] == oracle.insert(u, v, lab, ts), (seed, i)
        for qi, eng in enumerate(indep):
            assert fresh[qi] == eng.insert(u, v, lab, ts), (seed, i, qi)
        if i % 7 == 6:
            group.expire(ts)
            oracle.expire(ts)
            for eng in indep:
                eng.expire(ts)
    assert group.port.per_query_results[lane] == oracle.results
    for qi, eng in enumerate(indep):
        assert group.port.per_query_results[qi] == eng.results
    group.assert_equal()


def test_deregister_keeps_survivors_and_reclaims_lane():
    rng = random.Random(7)
    window = 20.0
    specs = [(f"q{i}", e, window) for i, e in enumerate(QUERIES[:3])]
    group = TwinGroup(specs, n_slots=16)
    indep = {i: _indep(e, window) for i, (_n, e, _w) in enumerate(specs)}
    stream = random_stream(rng, 6, 30, 90)
    for (u, v, lab, ts) in stream[:12]:
        fresh = group.insert(u, v, lab, ts)
        for qi, eng in indep.items():
            assert fresh[qi] == eng.insert(u, v, lab, ts)

    cap_before = group.port.q_cap
    group.deregister("q1")
    del indep[1]
    assert group.port.n_queries == group.jax.n_queries == 2
    assert group.port.q_cap == cap_before
    assert group.current_results(1) == set()

    for (u, v, lab, ts) in stream[12:20]:
        fresh = group.insert(u, v, lab, ts)
        assert fresh[1] == set()
        for qi, eng in indep.items():
            assert fresh[qi] == eng.insert(u, v, lab, ts)

    oracle, oseed = _oracle_for("b . a*", "arbitrary", group, window, 16)
    initial = group.register("q3", "b . a*", window)
    assert group.lane_of("q3") == 1
    assert group.port.q_cap == cap_before
    assert initial == oseed
    for (u, v, lab, ts) in stream[20:]:
        fresh = group.insert(u, v, lab, ts)
        assert fresh[1] == oracle.insert(u, v, lab, ts)
        for qi, eng in indep.items():
            assert fresh[qi] == eng.insert(u, v, lab, ts)
    assert group.port.per_query_results[1] == oracle.results
    group.assert_equal()


def test_q_axis_bucket_growth():
    window = 30.0
    group = TwinGroup([("q0", "a*", window)], n_slots=8)
    assert group.port.q_cap == group.jax.q_cap == 1
    group.insert(0, 1, "a", 1.0)
    group.register("q1", "a . b*", window)
    assert group.port.q_cap == 4
    assert group.port.batched_arrays.dist.shape[0] == 4
    for i in range(2):
        group.register(f"q{2 + i}", "b*", window)
        assert group.port.q_cap == 4
    group.register("q4", "(a|b)*", window)
    assert group.port.q_cap == 8
    assert group.port.n_queries == group.jax.n_queries == 5
    assert group.port.k == group.jax.k
    fresh = group.insert(1, 2, "b", 2.0)
    assert fresh[group.lane_of("q1")] == {(0, 2)}
    group.assert_equal()


def test_register_with_new_label_grows_alphabet():
    window = 50.0
    group = TwinGroup([("q0", "a*", window)], n_slots=8)
    group.insert(0, 1, "a", 1.0)
    assert group.port.batched_arrays.adj.shape[0] == 4
    group.register("qd", "d . a*", window)
    assert group.port.labels == ("a", "d")
    lane = group.lane_of("qd")
    fresh = group.insert(5, 0, "d", 2.0)
    assert fresh[lane] == {(5, 0), (5, 1)}
    group.register("qmany", "e | f | g | h", window)
    assert group.port.labels == ("a", "d", "e", "f", "g", "h")
    assert group.port.batched_arrays.adj.shape[0] == 8
    fresh = group.insert(7, 8, "g", 3.0)
    assert fresh[group.lane_of("qmany")] == {(7, 8)}
    assert group.current_results(0) == {(0, 1)}
    group.assert_equal()


@pytest.mark.parametrize("seed", range(4))
def test_churn_conformance_randomized(seed):
    case = churn_case(seed)
    window = case["window"]
    group = TwinGroup(case["specs"], n_slots=16)
    indep = {qi: _indep(e, window, s)
             for qi, (_n, e, _w, s) in enumerate(case["specs"])}
    oracles = {}

    def lifecycle(step):
        if step == LATE1:
            expr, semantics = case["late1"]
            oracle, oseed = _oracle_for(expr, semantics, group, window, 16)
            initial = group.register("late1", expr, window, semantics)
            assert initial == oseed, (seed, expr)
            oracles[group.lane_of("late1")] = oracle
        elif step == DEREGISTER:
            group.deregister("q1")
            del indep[1]
        elif step == LATE2:
            oracle, oseed = _oracle_for(case["late2"], "arbitrary", group, window, 16)
            initial = group.register("late2", case["late2"], window)
            lane = group.lane_of("late2")
            assert lane == 1, seed
            assert initial == oseed, seed
            oracles[lane] = oracle

    for i, (op, u, v, lab, ts) in enumerate(case["events"]):
        lifecycle(i)
        if op == "+":
            fresh = group.insert(u, v, lab, ts)
            for qi, eng in indep.items():
                assert fresh[qi] == eng.insert(u, v, lab, ts), (seed, i, qi)
            for lane, oracle in oracles.items():
                assert fresh[lane] == oracle.insert(u, v, lab, ts), (seed, i, lane)
        else:
            inv = group.delete(u, v, lab, ts)
            for qi, eng in indep.items():
                assert inv[qi] == eng.delete(u, v, lab, ts), (seed, i, qi)
            for lane, oracle in oracles.items():
                assert inv[lane] == oracle.delete(u, v, lab, ts), (seed, i, lane)
        if i % 7 == 6:
            group.expire(ts)
            for eng in indep.values():
                eng.expire(ts)
            for oracle in oracles.values():
                oracle.expire(ts)
        if i % 9 == 8:
            for qi, eng in indep.items():
                assert group.current_results(qi) == eng.current_results()
            for lane, oracle in oracles.items():
                assert group.current_results(lane) == oracle.current_results()

    for qi, eng in indep.items():
        assert group.port.per_query_results[qi] == eng.results, (seed, qi)
    for lane, oracle in oracles.items():
        assert group.port.per_query_results[lane] == oracle.results, (seed, lane)
    group.assert_equal()


def test_convergence_masking_reduces_query_rounds():
    window = 100.0
    specs = [("deep", "a*", window), ("shallow", "b", window)]
    group = TwinGroup(specs, n_slots=16)
    indep = [_indep(e, window) for _n, e, _w in specs]
    edges = [(i, i + 1, "a", float(i + 1)) for i in range(10)]
    edges.append((0, 1, "b", 11.0))
    for (u, v, lab, ts) in edges:
        fresh = group.insert(u, v, lab, ts)
        for qi, eng in enumerate(indep):
            assert fresh[qi] == eng.insert(u, v, lab, ts)
    for qi, eng in enumerate(indep):
        assert group.port.per_query_results[qi] == eng.results
    assert group.port.total_query_rounds < \
        group.port.n_queries * group.port.total_rounds
    group.assert_equal()   # query_rounds_total and unmasked too


def test_service_live_lifecycle_and_invalidations():
    svc = TwinService(window=100.0, slide=50.0)
    svc.register("d", "a . a*", engine="dense", n_slots=16)
    svc.register("r", "a . a*", engine="reference")
    rep = svc.ingest([(1.0, 1, 2, "a"), (2.0, 2, 3, "a")])
    assert rep["d"] == {(1, 2), (2, 3), (1, 3)} == rep["r"]
    assert rep.invalidated["d"] == set() == rep.invalidated["r"]

    rep2 = svc.ingest([(3.0, 2, 3, "a", "-")])
    assert rep2["d"] == set()
    assert rep2.invalidated["d"] == {(2, 3), (1, 3)}
    assert rep2.invalidated["r"] == {(2, 3), (1, 3)}

    initial = svc.register("late", "a", engine="dense")
    assert initial == {(1, 2)}
    assert svc.results("late") == {(1, 2)}

    rep3 = svc.ingest([(4.0, 3, 4, "a")])
    assert rep3["late"] == {(3, 4)}

    svc.deregister("late")
    with pytest.raises(KeyError):
        svc.port.results("late")
    rep4 = svc.ingest([(5.0, 4, 5, "a")])
    assert rep4["late"] == set()
    assert (4, 5) in rep4["d"]
    assert svc.results("r") == svc.results("d")


def test_first_dense_registration_mid_stream_starts_tracking():
    svc = TwinService(window=100.0, slide=50.0)
    svc.register("r", "a", engine="reference")
    svc.ingest([(1.0, 1, 2, "a")])
    initial = svc.register("late", "a", engine="dense", n_slots=16)
    assert initial == set()
    group = svc.port.queries["late"]
    assert group is not None and group.n_queries == 1
    assert svc.jax.queries["late"].n_queries == 1
    rep = svc.ingest([(2.0, 3, 4, "a")])
    assert rep["late"] == {(3, 4)}
    assert svc.results("r") == {(1, 2), (3, 4)}
    initial2 = svc.register("late2", "a", engine="dense")
    assert initial2 == {(3, 4)}


def test_reregistered_name_keeps_stats_history():
    svc = TwinService(window=100.0, slide=50.0)
    svc.register("d", "a", engine="dense", n_slots=16)
    svc.ingest([(1.0, 1, 2, "a")])
    assert svc.tuples("d") == 1
    svc.deregister("d")
    assert svc.tuples("d") == 1
    svc.register("d", "a . a*", engine="dense")
    assert svc.tuples("d") == 1
    svc.ingest([(2.0, 2, 3, "a")])
    assert svc.tuples("d") == 2


def test_service_checkpoint_records_live_query_set():
    """Both packages' manifests record the same live query set lane by
    lane (None = inert padding); the port's restores by name into a
    differently laid-out fresh service."""
    svc = TwinService(window=50.0, slide=10.0)
    svc.register("q0", "a*", engine="dense", n_slots=16)
    svc.ingest([(1.0, 0, 1, "a")])
    svc.register("q1", "a . b*", engine="dense")   # grows Q to a bucket of 4
    svc.deregister("q0")
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        svc.jax.snapshot(dj, step=3)
        svc.port.snapshot(dt, step=3)
        extra = ckpt.manifest_extra(dt)
        assert extra["dense"] == jax_ckpt.manifest_extra(dj)["dense"]
        lanes = extra["dense"]["order"]
        assert lanes[1] == "q1" and lanes[0] is None
        assert extra["dense"]["labels"] == ["a", "b"]
        svc2 = PersistentQueryService(window=50.0, slide=10.0, device="cpu")
        svc2.register("q1", "a . b*", engine="dense", n_slots=16)
        assert svc2.restore(dt) == 3
        assert svc2.results("q1") == svc.results("q1")


@pytest.mark.parametrize("seed", range(2))
def test_churn_oracle_equals_the_jax_oracle(seed):
    """The port's ``make_churn_oracle`` against the JAX one on the same
    group history (inserts, deletions, expiry, one churn): the same seed
    set, then the same results event by event on the tail."""
    rng = random.Random(200 + seed)
    window = 20.0
    group = TwinGroup([("q0", "a . b*", window), ("q1", "(a | b)*", window)],
                      n_slots=16)
    stream = random_stream(rng, 7, 36, 60)
    for i, (u, v, lab, ts) in enumerate(stream[:18]):
        if i % 5 == 4:
            group.delete(u, v, lab, ts)
        else:
            group.insert(u, v, lab, ts)
        if i % 6 == 5:
            group.expire(ts)
    group.deregister("q1")
    expr, semantics = ("a . b* . c", "arbitrary") if seed == 0 else ("a . b*", "simple")
    jo, jseed = jax_churn_oracle(jax_compile(expr), group.jax, window, 16,
                                 path_semantics=semantics)
    to, tseed = make_churn_oracle(compile_query(expr), group.port, window, 16,
                                  path_semantics=semantics)
    assert tseed == jseed
    assert to.device == group.port.device
    assert to.host_now == jo.host_now == group.port.host_now
    assert to.batch_size == jo.batch_size == 1
    for i, (u, v, lab, ts) in enumerate(stream[18:]):
        assert to.insert(u, v, lab, ts) == jo.insert(u, v, lab, ts), i
        if i % 6 == 5:
            to.expire(ts)
            jo.expire(ts)
    assert to.results == jo.results
    assert to.current_results() == jo.current_results()
