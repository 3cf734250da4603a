"""Hand a JAX engine's state over to a port engine.

The system has no weights; its state is the stream it has seen. To run the
same computation on both packages from the middle of a stream, export the
reference engine's device state (``np.asarray`` of each leaf of its
``state_arrays()``), its ``interner_state()`` and its ``results_state()``,
and load them here. The port engine must have been built with the same
queries in the same lanes and the same capacities (slots, lanes, states,
label slots); both engines then compute the same thing from the next
event on. Nothing here imports JAX: the inputs are numpy arrays and
JSON-able dicts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .engine import BatchedDenseRPQEngine


def carry_reference_state(engine: BatchedDenseRPQEngine,
                          state_np: Dict[str, np.ndarray],
                          interner: Dict[str, object],
                          results: Dict[str, object]) -> None:
    """Load a reference engine's exported state, interner and results into
    ``engine`` (shapes must match exactly; raises ``ValueError`` if not)."""
    names = [s.name for _qi, s in engine.live_items()]
    missing = set(results["results"]) ^ set(names)
    if missing:
        raise ValueError(f"query sets differ: {sorted(missing)}")
    engine.load_state_arrays({k: np.asarray(v) for k, v in state_np.items()})
    engine.load_interner(interner)
    engine.load_results_state(results)
