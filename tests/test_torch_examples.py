"""The port's RPQ examples (examples/{quickstart,streaming_service,
distributed_rpq}_torch.py) as entry points: each runs with ``--device cpu``,
the quickstart's and the distributed example's result sets equal the JAX
engine's on the same stream, none imports JAX or ``repro``, and each
raises without a card unless the CPU is asked for."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.core.automaton import compile_query as jax_compile
from repro.core.engine import DenseRPQEngine as JaxDense
from repro.streaming.generators import so_like as jax_so_like

from _torch_imports import assert_loads_neither_jax_nor_repro

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart_torch", "streaming_service_torch", "distributed_rpq_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread, so the test workers do
    not spin-wait against each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_equals_the_jax_engine(capsys):
    ex = _load("quickstart_torch")
    got = ex.main(["--device", "cpu"])
    ref = JaxDense(jax_compile(ex.QUERY), window=ex.WINDOW, n_slots=16,
                   batch_size=1)
    for (ts, u, v, label) in ex.STREAM:
        ref.insert(u, v, label, ts)
    assert got == ref.results
    assert ("x", "y") in got
    assert "final (monotone) result set" in capsys.readouterr().out


def test_streaming_service_runs_with_its_checkpoint_drill(capsys):
    got = _load("streaming_service_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[ckpt] snapshot + re-attach" in out and "ingested" in out
    assert set(got) == {"notify", "notify_simple", "reach_ref"}
    assert got["notify"] and got["reach_ref"]
    # the simple-path lane drops only the (x, x) pairs of a conflict-free
    # query: its results are the arbitrary lane's without them
    assert got["notify_simple"] == {p for p in got["notify"] if p[0] != p[1]}


def test_distributed_example_equals_the_jax_engine(capsys):
    got = _load("distributed_rpq_torch").main(["--device", "cpu"])
    ref = JaxDense(jax_compile("a2q . c2a*"), window=30.0, n_slots=64,
                   batch_size=32)
    for batch in jax_so_like(n_vertices=48, n_edges=800, seed=9).batches(32):
        ref.insert_batch([s.as_edge() for s in batch])
    assert got == ref.results
    out = capsys.readouterr().out
    assert "grid: {'data': 4, 'model': 2}" in out


def test_examples_load_neither_jax_nor_repro():
    assert_loads_neither_jax_nor_repro(
        "import importlib.util\n"
        f"for name in {NAMES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(EXAMPLES)!r} + f'/{{name}}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_a_card_unless_the_cpu_is_asked_for(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
