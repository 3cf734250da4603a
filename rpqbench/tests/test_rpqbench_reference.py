"""The plain reference on hand-worked streams, and against the port's
service on the CPU (the reference itself imports nothing of the port)."""
import ast
from pathlib import Path

import pytest

from rpqbench.automaton import compile_query
from rpqbench.generator import so_like, with_deletions
from rpqbench.reference import FALLBACK_REASON, ServiceReference, SimpleLane

BENCH = Path(__file__).resolve().parents[1]
Q2, Q3 = "a2q . c2a*", "a2q . c2a* . c2q*"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "automaton.py", "generator.py",
                 "generators/so_like.py", "roofline.py"):
        tree = ast.parse((BENCH / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
        assert not {m.split(".")[0] for m in mods} & {"repro_torch", "repro", "jax", "torch"}


def test_compiler_suffix_containment():
    dfa = compile_query(Q3)
    assert dfa.k == 3 and dfa.finals == frozenset({1, 2})
    assert dfa.containment[1, 2] and not dfa.containment[2, 1]
    assert not dfa.has_containment_property
    assert compile_query("(a2q | c2a | c2q)*").has_containment_property


def ev(ref, ts, u, v, lab, op="+"):
    return ref.event(ts, u, v, lab, op)


def test_window_expiry_deletes_and_append_only_results():
    ref = ServiceReference(20.0, 2.0)
    assert ref.register("q", Q2) == set()
    assert ev(ref, 1.0, 1, 2, "a2q")[0] == {"q": {(1, 2)}}
    assert ev(ref, 2.5, 2, 3, "c2a")[0] == {"q": {(1, 3)}}
    assert ev(ref, 3.0, 3, 4, "c2q") == ({}, {}, {})        # not in the language
    # a slide boundary drops the edges at or below 25 - 20
    assert ev(ref, 25.0, 4, 5, "a2q")[0] == {"q": {(4, 5)}}
    assert (1, 2, "a2q") not in ref.graph.edges
    assert ev(ref, 26.0, 5, 6, "c2a")[0] == {"q": {(4, 6)}}
    assert ev(ref, 27.0, 5, 6, "c2a")[0] == {}               # newer copy: nothing new
    new, inv, _ = ev(ref, 28.0, 5, 6, "c2a", "-")
    assert new == {} and inv == {"q": {(4, 6)}}
    assert ev(ref, 29.0, 5, 6, "c2a")[0] == {}               # reported once, ever
    assert ev(ref, 30.0, 9, 9, "x") == ({}, {}, {})          # outside the alphabet


def test_path_validity_is_its_oldest_edge():
    ref = ServiceReference(20.0, 2.0)
    ref.register("q", Q2)
    ev(ref, 1.0, 1, 2, "a2q")
    assert ev(ref, 20.5, 2, 3, "c2a")[0] == {"q": {(1, 3)}}  # 1.0 > 20.5 - 20
    assert ev(ref, 21.5, 3, 4, "c2a")[0] == {}               # 1.0 <= 21.5 - 20
    assert ev(ref, 22.0, 7, 3, "a2q")[0] == {"q": {(7, 3), (7, 4)}}


def test_late_registration_and_retirement():
    ref = ServiceReference(20.0, 2.0)
    ref.register("q", Q2)
    ev(ref, 1.0, 1, 2, "a2q")
    ev(ref, 2.0, 2, 3, "c2a")
    assert ref.register("late", "c2a") == {(2, 3)}
    assert ref.register("late2", Q2) == {(1, 2), (1, 3)}    # shares q's closure
    new, _, _ = ev(ref, 3.0, 3, 4, "c2a")
    assert new == {"q": {(1, 4)}, "late": {(3, 4)}, "late2": {(1, 4)}}
    ref.deregister("q")
    new, inv, _ = ev(ref, 4.0, 2, 3, "c2a", "-")
    assert new == {} and inv == {"late": {(2, 3)}, "late2": {(1, 3), (1, 4)}}
    assert ev(ref, 5.0, 8, 9, "a2q")[0] == {"late2": {(8, 9)}}


def test_simple_lane_drops_cycles_and_hands_over_on_conflict():
    ref = ServiceReference(20.0, 2.0)
    ref.register("q3", Q3)
    ref.register("q3s", Q3, simple=True)
    ev(ref, 1.0, 6, 7, "a2q")
    new, _, fb = ev(ref, 2.0, 7, 6, "c2a")
    assert new == {"q3": {(6, 6)}} and fb == {}              # (x, x) is not simple
    ev(ref, 3.0, 0, 1, "a2q")                                # x -a2q-> y
    ev(ref, 4.0, 1, 2, "c2q")                                # y -c2q-> z: (0, 2) in s2
    new, _, fb = ev(ref, 5.0, 0, 2, "a2q")                   # x -a2q-> z: (0, 2) in s1
    assert fb == {"q3s": FALLBACK_REASON} and "q3s" in ref.fallbacks
    assert "q3s" not in ref.lanes
    new, _, _ = ev(ref, 6.0, 2, 5, "c2a")                    # now the RSPQ answers
    assert new == {"q3": {(0, 5)}, "q3s": {(0, 5)}}


def test_simple_lane_counts_only_paths_that_visit_no_vertex_twice():
    lane = SimpleLane(compile_query("a2q . c2a . c2q"), 20.0, set(), [], float("-inf"))
    assert lane.insert(1, 2, "a2q", 1.0) == set()
    assert lane.insert(2, 3, "c2a", 2.0) == set()
    assert lane.insert(3, 2, "c2q", 3.0) == set()            # 1-2-3-2 visits 2 twice
    assert lane.insert(3, 4, "c2q", 4.0) == {(1, 4)}
    assert lane.insert(3, 1, "c2q", 4.5) == set()            # back to the source
    assert lane.delete(2, 3, "c2a", 5.0) == {(1, 4)}
    assert lane.delete(2, 3, "c2a", 5.5) == set()            # not there any more
    assert lane.insert(2, 3, "c2a", 6.0) == set()            # reported once, ever
    assert lane.insert(5, 6, "a2q", 22.5) == set()           # 1.0 <= 22.5 - 20
    lane.expire(22.5)
    assert (2, 0) not in lane.out.get(1, {})
    assert lane.delete(3, 4, "c2q", 23.0) == set()           # (1, 4) was not valid


def test_simple_lane_after_hand_over_starts_from_the_retained_edges():
    """Seeded with the retained edges, the lane's answers so far and the
    clock, it reports only what is new."""
    lane = SimpleLane(compile_query(Q2), 20.0, {(1, 2)},
                      [(1, 2, "a2q", 1.0), (2, 3, "c2a", 2.0), (9, 9, "c2q", 3.0)], 3.5)
    assert lane.now == 3.5
    assert lane.insert(3, 4, "c2a", 4.0) == {(1, 3), (1, 4)}
    assert lane.insert(4, 1, "c2a", 5.0) == set()            # (1, 1) is not simple
    assert lane.delete(2, 3, "c2a", 6.0) == {(1, 3), (1, 4)}


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_equals_the_port_per_event(seed):
    """The port's service on the CPU at 64 slots, one sgt a call, with late
    registrations, a retirement and simple lanes: every answer equal."""
    import torch

    from repro_torch.streaming.service import PersistentQueryService

    torch.set_num_threads(1)
    queries = {"Q1": "a2q*", "Q2": Q2, "Q3": Q3, "Q4": "(a2q | c2a | c2q)*",
               "Q5": "a2q . c2a* . c2q", "Q11": "a2q . c2a . c2q"}
    stream = with_deletions(so_like(64, 160, seed, 10.0), 0.05, seed + 1)
    svc = PersistentQueryService(window=20.0, slide=2.0, device="cpu")
    ref = ServiceReference(20.0, 2.0)
    lanes = [(n, e, False) for n, e in queries.items()] + [("Q3s", Q3, True)]
    for name, expr, simple in lanes:
        svc.register(name, expr, engine="dense", n_slots=64, batch_size=1,
                     path_semantics="simple" if simple else "arbitrary")
        ref.register(name, expr, simple)
    for i, s in enumerate(stream):
        if i == len(stream) // 2:
            for name, expr, simple in (("late4", queries["Q4"], False), ("late2s", Q2, True)):
                got = svc.register(name, expr, engine="dense",
                                   path_semantics="simple" if simple else "arbitrary")
                assert got == ref.register(name, expr, simple)
            svc.deregister("Q5")
            ref.deregister("Q5")
        rep = svc.ingest([s])
        new, inv, fb = ref.event(s.ts, s.src, s.dst, s.label, s.op)
        assert {k: v for k, v in rep.items() if v} == new, i
        assert {k: v for k, v in rep.invalidated.items() if v} == inv, i
        assert rep.fallbacks == fb, i
