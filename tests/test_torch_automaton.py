"""The port's query compiler against the JAX package's: the same minimal
DFA (labels, transitions, start, finals) and the same RSPQ metadata
(suffix containment, containment property) for the paper's Table-2
queries and those of tests/test_automaton.py."""
import numpy as np
import pytest

from repro.core.automaton import compile_query as jax_compile
from repro.core.batch import batch_rapq as jax_batch_rapq
from repro.core.batch import snapshot_from_edges as jax_snapshot
from repro_torch.core.automaton import compile_query
from repro_torch.core.batch import batch_rapq, snapshot_from_edges

TABLE2 = ["a*", "a . b*", "a . b* . c*", "(a | b | c)*", "a . b* . c",
          "a* . b*", "a . b . c*", "a? . b*", "(a | b | c)+",
          "(a | b | c) . b*", "a . b . c"]
SO = ["a2q . c2a*", "(a2q | c2a | c2q)+", "a2q . c2a* . c2q*", "a2q? . c2a*"]
FROM_AUTOMATON_TESTS = ["(a1 + a2 + a3)*", "(a1 + a2 + a3)+",
                        "(a1 + a2 + a3) . b*", "a1 . a2 . a3",
                        "(follows . mentions)+", "a . b", "(a . b)+",
                        "(a|b|c)*", "a+", "a + b", "a b c", "()", "a?"]


@pytest.mark.parametrize("expr", TABLE2 + SO + FROM_AUTOMATON_TESTS)
def test_dfa_and_rspq_metadata_match(expr):
    ref = jax_compile(expr)
    dfa = compile_query(expr)
    assert dfa.labels == ref.labels
    assert dfa.start == ref.start
    assert dfa.finals == ref.finals
    assert dfa.transitions() == ref.transitions()
    np.testing.assert_array_equal(dfa.delta, ref.delta)
    np.testing.assert_array_equal(dfa.containment, ref.containment)
    assert dfa.has_containment_property == ref.has_containment_property


def test_batch_oracle_matches():
    rng = np.random.default_rng(5)
    edges = [(int(rng.integers(8)), int(rng.integers(8)),
              str(rng.choice(["a", "b", "c"])), float(t)) for t in range(40)]
    for expr in TABLE2:
        got = batch_rapq(snapshot_from_edges(edges), compile_query(expr))
        ref = jax_batch_rapq(jax_snapshot(edges), jax_compile(expr))
        assert got == ref, expr
