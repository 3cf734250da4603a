"""CLI: ``python -m repro_torch.analysis [paths...] [--format=text|json]
[--rules R1,R5]``.

Exits 1 iff any unsuppressed finding remains, else 0.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .analyzer import format_json, format_text, run


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Dispatch-hygiene static analysis of the PyTorch/CUDA "
                    "port (rules R1-R5; see the package docstring)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze (default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule subset, e.g. R1,R5")
    args = ap.parse_args(argv)

    paths = args.paths or ["src/repro_torch"]
    rules = [r for r in args.rules.split(",") if r.strip()] or None
    findings, n_files = run(paths, rules)
    if args.format == "json":
        print(format_json(findings, n_files))
    else:
        print(format_text(findings, n_files))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
