"""The local cases of tests/test_sparse_dist.py on the port's row-sparse
engine against the JAX engine's, event by event and leaf for leaf: the
overflow-table regression (``dist_cap=1``, a 512-row table, B=4),
vertex-axis growth with compaction, and query churn. The events, queries
and windows are drawn as tests/test_sparse_dist.py draws them. Per event:
results, invalidations, dist telemetry and the raw ``RowSparseDist``
leaves; at the end the dense state and every counter. Tolerance 0.
"""
import random

import pytest

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import BatchedDenseRPQEngine as JaxEngine
from repro.core.engine import RegisteredQuery as JaxQuery
from repro.core.executor import LocalExecutor as JaxLocal
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import BatchedDenseRPQEngine, RegisteredQuery
from repro_torch.core.executor import LocalExecutor
from _torch_pairs import assert_dist_leaves_equal, assert_state_equal
from _torch_pairs import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUERIES = ["a*", "a . b*", "(a | b)*", "a . b* . c", "(a . b)+", "a . b . c"]
LABELS = ["a", "b", "c"]


def _random_events(rng, n_vertices, n_edges, t_max):
    """tests/test_sparse_dist.py's event generator (15% deletions)."""
    ts = sorted(rng.sample(range(1, t_max), k=min(n_edges, t_max - 1)))
    live = {}
    events = []
    for t in ts:
        u, v = rng.randrange(n_vertices), rng.randrange(n_vertices)
        lab = rng.choice(LABELS)
        if live and rng.random() < 0.15:
            du, dv, dl = rng.choice(sorted(live))
            del live[(du, dv, dl)]
            events.append(("-", du, dv, dl, float(t)))
        else:
            live[(u, v, lab)] = t
            events.append(("+", u, v, lab, float(t)))
    return events


def _specs(rng, n_queries, window):
    """tests/test_sparse_dist.py's query draw: (name, expr, semantics)."""
    specs = []
    for qi in range(n_queries):
        expr = rng.choice(QUERIES)
        simple = (jax_compile(expr).has_containment_property
                  and rng.random() < 0.4)
        specs.append((f"q{qi}", expr, "simple" if simple else "arbitrary"))
    return specs


def _pair(specs, window, n_slots, batch_size, **kw):
    je = JaxEngine([JaxQuery(n, jax_compile(e), window, s) for n, e, s in specs],
                   n_slots=n_slots, batch_size=batch_size,
                   executor=JaxLocal("jnp", **kw))
    te = BatchedDenseRPQEngine(
        [RegisteredQuery(n, compile_query(e), window, s) for n, e, s in specs],
        n_slots=n_slots, batch_size=batch_size,
        executor=LocalExecutor(None, device="cpu", **kw))
    return je, te


def _event(eng, ev, shift=0.0):
    op, u, v, lab, t = ev
    if op == "+":
        return eng.insert(u, v, lab, t + shift)
    return eng.delete(u, v, lab, t + shift)


def _drive_events(je, te, events, slide=5.0, shift=0.0):
    nxt = slide + shift
    for i, ev in enumerate(events):
        t = ev[4] + shift
        if t >= nxt:
            je.expire(t)
            te.expire(t)
            while nxt <= t:
                nxt += slide
        assert _event(je, ev, shift) == _event(te, ev, shift), (i, ev)
        assert te.executor.dist_stats == je.executor.dist_stats, i
        assert_dist_leaves_equal(je, te, (i, ev))


def _conformance(seed, n_slots=24, batch_size=1, **dist_kw):
    rng = random.Random(seed)
    window = rng.choice([10.0, 25.0])
    specs = _specs(rng, 3, window)
    events = _random_events(rng, 14, 80, 70)
    je, te = _pair(specs, window, n_slots, batch_size,
                   **{"dist_layout": "row_sparse", "dist_cap": 4, **dist_kw})
    _drive_events(je, te, events)
    assert te.retained_edges() == je.retained_edges()
    assert_state_equal(je, te)
    return te


def test_overflow_table_regression():
    """dist_cap=1 and a 512-row table at B=4: most rows overflow, the
    budget forces drains, drains grow and re-pack; nothing is lost."""
    te = _conformance(3, batch_size=4, dist_cap=1, dist_ovf_cap=512)
    st = te.executor.dist_stats
    assert st["drains"] > 0 and st["repacks"] > 0 and st["dist_cap"] > 1
    assert st["lost"] == 0
    assert st["live_entries"] is not None and st["live_entries"] > 0


def test_survives_slot_growth_and_compaction():
    """More distinct vertices than 8 slots: compaction recycles slots and
    the vertex axis grows through the canonical dense slab."""
    te = _conformance(5, n_slots=8, batch_size=2)
    assert te.n_slots > 8


def test_survives_query_churn():
    """A query registered mid-stream and another deregistered: the lane
    lifecycle clears and seeds lanes of the row-sparse state in place."""
    rng = random.Random(6)
    specs = _specs(rng, 2, 20.0)
    head = _random_events(rng, 10, 40, 35)
    tail = _random_events(random.Random(7), 10, 30, 35)
    je, te = _pair(specs, 20.0, 16, 2, dist_layout="row_sparse", dist_cap=2)
    _drive_events(je, te, head)
    assert je.register_query(JaxQuery("late", jax_compile("a . b*"), 20.0)) == \
        te.register_query(RegisteredQuery("late", compile_query("a . b*"), 20.0))
    assert_dist_leaves_equal(je, te, "register")
    je.deregister_query("q0")
    te.deregister_query("q0")
    assert_dist_leaves_equal(je, te, "deregister")
    _drive_events(je, te, tail, shift=35.0)
    assert_state_equal(je, te)
