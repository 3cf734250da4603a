"""Hand a JAX engine's state over to a port engine.

The system has no weights; its state is the stream it has seen. To run the
same computation on both packages from the middle of a stream, export the
reference engine's device state (``np.asarray`` of each leaf of its
``state_arrays()``), its ``interner_state()`` and its ``results_state()``,
and load them here. The port engine must have been built with the same
queries in the same lanes and the same capacities (slots, lanes, states,
label slots); both engines then compute the same thing from the next
event on. A row-sparse port engine packs the exported dense dist afresh;
:func:`carry_reference_dist` then takes over the JAX engine's own
``RowSparseDist`` leaves, so both continue from the same slot layout.
Nothing here imports JAX: the inputs are numpy arrays and JSON-able dicts.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .engine import BatchedDenseRPQEngine
from .sparse_dist import RowSparseDist, from_numpy


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


def carry_reference_dist(engine: BatchedDenseRPQEngine,
                         leaves: Sequence[np.ndarray],
                         budget: int = 0) -> None:
    """Replace a row-sparse engine's dist with a JAX ``RowSparseDist``'s
    numpy leaves (in field order), taking over their slot and table
    capacities and the JAX executor's claim budget since its last drain
    (``budget``), so drains fall on the same dispatches. Call it after
    :func:`carry_reference_state`; shapes must match the engine's lanes,
    slots and states."""
    ex = engine.executor
    if ex.dist_layout != "row_sparse":
        raise ValueError("carry_reference_dist needs dist_layout='row_sparse'")
    sd = from_numpy(RowSparseDist(*leaves), ex.device)
    if (sd.n_lanes, sd.n_slots, sd.n_slots, sd.k) != ex.dist_shape:
        raise ValueError(f"row-sparse leaves of logical shape "
                         f"{(sd.n_lanes, sd.n_slots, sd.n_slots, sd.k)}, this "
                         f"engine holds {ex.dist_shape}")
    ex.load_dist(sd, budget)
