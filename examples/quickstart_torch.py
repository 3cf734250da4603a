"""Quickstart on the PyTorch port: register one persistent RPQ over a toy
social stream and watch answers appear incrementally (Fig. 1 of the paper,
end to end). Runs on the CUDA card; add ``--device cpu`` to run the
kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
from typing import Optional, Sequence, Set, Tuple

from repro_torch.core import compile_query
from repro_torch.core.engine import DenseRPQEngine
from repro_torch.device import resolve_device

# Fig. 1: who is connected to whom by alternating follows/mentions edges?
QUERY = "(follows . mentions)+"
WINDOW = 15.0

STREAM = [
    # (ts, src, dst, label)
    (1.0, "x", "y", "follows"),
    (3.0, "x", "y", "follows"),
    (4.0, "y", "u", "mentions"),
    (8.0, "x", "z", "follows"),
    (12.0, "u", "v", "follows"),
    (13.0, "x", "y", "follows"),
    (14.0, "z", "u", "mentions"),
    (18.0, "v", "y", "mentions"),
    (19.0, "w", "u", "follows"),
]


def main(argv: Optional[Sequence[str]] = None) -> Set[Tuple[object, object]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dfa = compile_query(QUERY)
    print(f"query {QUERY}: minimal DFA has {dfa.k} states over {dfa.labels}")
    engine = DenseRPQEngine(dfa, window=WINDOW, n_slots=16, batch_size=1,
                            device=device)
    for (ts, u, v, label) in STREAM:
        fresh = engine.insert(u, v, label, ts)
        if fresh:
            print(f"t={ts:5.1f}  +({u},{v},{label})  ->  new answers: {sorted(fresh)}")
        else:
            print(f"t={ts:5.1f}  +({u},{v},{label})")
    print("\nfinal (monotone) result set:", sorted(engine.results))
    assert ("x", "y") in engine.results  # the paper's running example
    print("snapshot-valid now:", sorted(engine.current_results()))
    return set(engine.results)


if __name__ == "__main__":
    main()
