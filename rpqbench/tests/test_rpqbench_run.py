"""run.py refuses to run where it must, the no-JAX check compares whole
top-level names, and the result line has the contract's shape."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from rpqbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.core.engine", "jaxtyping", "reprolib",
              "benchmarks_x", "torch", "numpy"]
    assert harness.forbidden_loaded(loaded) == []
    assert harness.forbidden_loaded(loaded + ["repro", "repro.core", "jax",
                                              "jaxlib.xla_client", "flax.linen",
                                              "benchmarks.fig4_throughput"]) == [
        "benchmarks.fig4_throughput", "flax.linen", "jax", "jaxlib.xla_client",
        "repro", "repro.core"]


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "rpqbench/run.py", "--workload", "so-dense-2048.steady",
         "--seed", "5", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_result_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rpqbench", tmp_path / "rpqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(small_cell, trace):
    cell = small_cell("so-dense-2048.steady")
    rec = harness.run_cell(cell, 2**31 + 3, 1e9, trace=trace, device="cpu",
                           max_window_sgts=60)
    line = harness.result_line(cell, rec, {"platform": "gpu", "kind": "x", "count": 1})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and ("breakdown" in line) == trace
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 60
    assert set(line["checks"]) == set(harness.CHECK_LIMITS)
    names = set(cell.per_layer if trace else cell.metrics)
    assert set(line["metrics"]) <= names
    if not trace:
        assert {"sgts_per_s", "latency_p95_ms", "setup_s"} <= set(line["metrics"])
    json.dumps(line)
