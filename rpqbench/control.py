"""The control of the output check: the program with its own
lower-precision path switched on, checked like the program. The service
keeps float32 timestamps; its bucket backend (``backend="mxu_bucket"``)
quantizes them to int levels of a step ``window / 8`` and runs the closure
on int8 tensor cores (kernel B3, B5 on levels), a coarsened expiry. It
has to come out not correct; its readings set the upper end of each
limit (PERF.md).

    python3 rpqbench/control.py --workload <cell> --seeds 11,12,13 --sgts 1800

runs the cell's traffic for ``--sgts`` window sgts (as many as a run of
the cell answers) on the card and prints one JSON line a seed with the
compared numbers. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL_BACKEND = "mxu_bucket"


def control_checks(cell, seed: int, sgts: int, device=None):
    """The checks of one control run of ``sgts`` window sgts."""
    from rpqbench import harness

    cell = copy.copy(cell)
    cell.config = copy.deepcopy(cell.config)
    cell.config["service"]["backend"] = CONTROL_BACKEND
    sync = None
    if device is None:
        import torch

        sync = torch.cuda.synchronize
    rec = harness.run_cell(cell, seed, seconds=1e9, device=device,
                           max_window_sgts=sgts, sync=sync)
    return rec.checks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--sgts", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from rpqbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        checks = control_checks(cell, seed, args.sgts)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "backend": CONTROL_BACKEND, "sgts": args.sgts,
                          "correct": harness.is_correct(checks), "checks": checks}),
              flush=True)


if __name__ == "__main__":
    main()
