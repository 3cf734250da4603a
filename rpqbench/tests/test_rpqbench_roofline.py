"""The roofline copies give PERF.md's figures and chip_smoke.py's bounds."""
import importlib.util
from pathlib import Path

import pytest

from rpqbench.roofline import bound_ell_ms, bound_ms

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_b1_bounds_match_perf_md():
    ms, by = bound_ms(40, 2048, 2048, 2048, ops=0)
    assert by == "bytes" and round(ms, 3) == 0.601
    ms, by = bound_ms(48, 2048, 2048, 2048)
    assert by == "operations" and round(ms, 3) == 12.308


@pytest.mark.parametrize("args", [
    (40, 16, 8192, 4, 10**6, 3, 256), (40, 8192, 8192, 4, 5 * 10**9, 3, 256),
    (1, 1, 9, 1, 3, 1, 0), (11, 4, 2048, 2, 10**12, 3, 64)])
def test_bounds_equal_chip_smoke(args):
    cs = _chip_smoke()
    assert bound_ell_ms(*args) == cs.bound_ell_ms(*args)
    j, m, u, e = args[:4]
    assert bound_ms(j, m, u, e) == cs.bound_ms(j, m, u, e)
