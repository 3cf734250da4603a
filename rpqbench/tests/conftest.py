"""CPU tests of the benchmark (``python -m pytest -q rpqbench/tests``);
the ``gpu``-marked ones run on the card
(``python -m pytest -q -m gpu rpqbench/tests``) and skip elsewhere."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json cut to 64 vertex slots and a 4 stream-second
    warm-up, for the CPU."""
    from rpqbench import harness

    def make(workload: str, n_slots: int = 64):
        cell = harness.load_cell(ROOT, workload)
        cell.config = copy.deepcopy(cell.config)
        cell.config["service"]["n_slots"] = n_slots
        cell.config["stream"]["n_vertices"] = n_slots
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.traffic["warmup"]["min_stream_s"] = 4.0
        return cell

    return make
