"""The benchmark of ``repro_torch``'s persistent-query service: one run of
one cell on the card it is started on.

    python3 rpqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds (first run of a checkout: nvcc into the checkout's ``build/``) or
loads the port's kernels, builds the cell from BENCHMARK.json and the
files it names, warms up, drives the window, checks every answer against
the plain reference and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit),
which also end standard error. Exits non-zero, printing no result,
without a CUDA card, outside a checkout that holds ``src/repro_torch``, or
when the process has loaded JAX, ``repro`` or ``benchmarks``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 2) -> None:
    print(f"rpqbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside the benchmark under {ROOT}")
    # every cache of a run lives in the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from rpqbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
    torch.set_num_threads(1)
    from repro_torch.kernels import build

    build.build_all(["maxmin", "ell"])    # one nvcc each, at once, where not built

    rec = harness.run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                           device=None, t_start=T_START, sync=torch.cuda.synchronize)
    line = harness.result_line(cell, rec, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips})
    loaded = harness.forbidden_loaded(sys.modules)
    if loaded:
        fail(f"the run loaded {loaded}", 3)
    for name, c in rec.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
