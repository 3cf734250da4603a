"""The port's engine over the row-sparse dist and the padded-ELL adjacency
against the JAX engine's, event by event and leaf for leaf (the dense
adjacency's cases are in tests/test_torch_rowsparse_engine.py), with
``frontier`` off, on and auto (auto from a capacity of 4): ``ell_cap=2``
with an 8-entry spill ring, ``dist_cap=16`` over 32 slots, so fallbacks,
spills, drains and re-packs of both layouts fire. Tolerance 0.
"""
import pytest

from _torch_pairs import check_row_sparse_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_engine_matches_per_event_ell():
    check_row_sparse_pair("auto", "ell")


@pytest.mark.parametrize("frontier", ["off", "on"])
def test_engine_matches_per_event_ell_fixed_frontier(frontier):
    check_row_sparse_pair(frontier, "ell")
