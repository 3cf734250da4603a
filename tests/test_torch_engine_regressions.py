"""The stream-clock and mid-chunk compaction regressions of
tests/test_engine_regressions.py on the port, each case built on both
packages (the JAX engine and the port's on the CPU) and compared call for
call: the fresh results, the clock, the interner's vertices and the
snapshot view.

1. stream clock on mixed chunks: every event's timestamp advances ``now``,
   also the out-of-alphabet ones of a chunk that is not skipped whole;
2. mid-chunk compaction: a vertex interned earlier in the chunk being
   packed (no adjacency entry yet) is pinned, not recycled.
"""
import pytest
import torch

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import DenseRPQEngine as JaxDense
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import DenseRPQEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Twin:
    """The JAX engine and the port's, built alike; each call goes to both
    and must return the same."""

    def __init__(self, expr, window, n_slots, batch_size):
        self.jax = JaxDense(jax_compile(expr), window=window, n_slots=n_slots,
                            batch_size=batch_size)
        self.port = DenseRPQEngine(compile_query(expr), window=window,
                                   n_slots=n_slots, batch_size=batch_size,
                                   device="cpu")

    def __call__(self, method, *args):
        a = getattr(self.jax, method)(*args)
        b = getattr(self.port, method)(*args)
        assert a == b, (method, args)
        return b

    @property
    def now(self):
        a, b = float(self.jax.arrays.now), float(self.port.arrays.now)
        assert a == b
        return b

    @property
    def vertices(self):
        assert self.port.slot_of == self.jax.slot_of
        return set(self.port.slot_of)


def test_mixed_chunk_advances_stream_clock():
    eng = Twin("a", window=5.0, n_slots=8, batch_size=4)
    eng("insert", 0, 1, "a", 1.0)
    assert eng("current_results") == {(0, 1)}
    fresh = eng("insert_batch", [(2, 3, "a", 2.0), (7, 8, "zz", 100.0)])
    assert eng.now == 100.0
    assert fresh == set()
    assert eng("current_results") == set()


def test_whole_chunk_skipped_still_advances_clock():
    eng = Twin("a", window=5.0, n_slots=8, batch_size=4)
    eng("insert", 0, 1, "a", 1.0)
    eng("insert_batch", [(7, 8, "zz", 50.0), (8, 9, "yy", 60.0)])
    assert eng.now == 60.0
    assert eng("current_results") == set()


def test_mid_chunk_compaction_preserves_chunk_vertices():
    eng = Twin("a", window=5.0, n_slots=2, batch_size=4)
    eng("insert", "x", "x", "a", 1.0)
    eng("delete", "ghost", "ghost", "a", 40.0)
    fresh = eng("insert_batch", [("u", "v", "a", 50.0)])
    assert eng.vertices == {"u", "v"}
    assert fresh == {("u", "v")}
    assert eng("current_results") == {("u", "v")}


def test_chunk_overflow_compaction_multi_edge_chunk():
    eng = Twin("a+", window=5.0, n_slots=3, batch_size=8)
    eng("insert", "o1", "o2", "a", 1.0)
    eng("delete", "ghost", "ghost", "a", 40.0)
    fresh = eng("insert_batch", [("p", "q", "a", 50.0), ("q", "r", "a", 51.0)])
    assert eng.vertices == {"p", "q", "r"}
    assert eng("current_results") == {("p", "q"), ("q", "r"), ("p", "r")}
    assert fresh == eng("current_results")
    assert eng.port.results == eng.jax.results
