"""The randomized churn scenario of tests/test_query_churn.py
(``test_churn_conformance_randomized``) as data, with the same draws from
the same seeded generator: the founding queries, the event stream with
deletions, and the two late registrations (at event 8, and at event 20
after ``q1`` deregisters at event 14). Shared by the port's CPU test
against the JAX package and its card test against the CPU."""
import random

from repro_torch.core.automaton import compile_query

QUERIES = ["a*", "a . b*", "(a | b)*", "a . b* . c", "(a . b)+", "a . b . c"]
LABELS = ["a", "b", "c"]
LATE1, DEREGISTER, LATE2 = 8, 14, 20   # the events the churn happens before


def random_stream(rng, n_vertices, n_edges, t_max):
    ts = sorted(rng.sample(range(1, t_max), k=min(n_edges, t_max - 1)))
    return [
        (rng.randrange(n_vertices), rng.randrange(n_vertices),
         rng.choice(LABELS), float(t))
        for t in ts
    ]


def churn_case(seed: int):
    """``window``, ``specs`` [(name, expr, window, semantics)], ``events``
    [(op, u, v, label, ts)], ``late1`` (expr, semantics) and ``late2``
    expr, drawn in the reference test's order."""
    rng = random.Random(100 + seed)
    window = rng.choice([10.0, 20.0, 40.0])
    specs = []
    for qi in range(3):
        expr = rng.choice(QUERIES)
        semantics = "arbitrary"
        if compile_query(expr).has_containment_property and rng.random() < 0.4:
            semantics = "simple"
        specs.append((f"q{qi}", expr, window, semantics))
    live = {}
    events = []
    for (u, v, lab, ts) in random_stream(rng, n_vertices=6, n_edges=26, t_max=70):
        if live and rng.random() < 0.2:
            du, dv, dl = rng.choice(sorted(live))
            del live[(du, dv, dl)]
            events.append(("-", du, dv, dl, ts))
        else:
            live[(u, v, lab)] = ts
            events.append(("+", u, v, lab, ts))
    expr = rng.choice(QUERIES)
    semantics = ("simple" if compile_query(expr).has_containment_property
                 and rng.random() < 0.5 else "arbitrary")
    late2 = rng.choice(QUERIES)
    return dict(window=window, specs=specs, events=events,
                late1=(expr, semantics), late2=late2)
