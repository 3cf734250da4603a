"""One traced run of a cell with the program's layer spans laid out, for
the breakdowns PERF.md keeps; the benchmark's own line is run.py's.

    python3 rpqbench/span_report.py --workload <cell> --seed <n> --seconds <s>

The window is ``run.py --trace 1``'s: spans and the profiler. Prints one
JSON line: sgts/s, the mean ``ingest`` call, the self time a sgt and the
count of each span name, the program counters' growth beside the
``sync.*`` counts, the spans dropped, the card's idle seconds by the
innermost span open over them, its five longest idle gaps with the span
that holds most of each, and the cell's per-layer metrics. Needs a CUDA
card, as run.py does; a program without spans gives the times alone.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def longest_idle(cover, top: int = 5):
    """The ``top`` longest of :func:`spans.idle_cover`'s gaps: seconds, and
    the innermost span that covers most of each with its share of the gap."""
    out = []
    for a, b, by_name in sorted(cover, key=lambda g: g[0] - g[1])[:top]:
        name, ns = max(by_name.items(), key=lambda kv: kv[1])
        out.append([(b - a) / 1e9, name, ns / (b - a)])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from rpqbench import harness, spans
    from repro_torch.kernels import build

    try:
        from repro_torch import obs
    except ImportError:                      # a program without spans
        obs = None

    if not torch.cuda.is_available():
        sys.exit("span_report: needs a CUDA card")
    torch.set_num_threads(1)
    build.build_all(["maxmin", "ell"])
    cell = harness.load_cell(ROOT, args.workload)
    if obs is not None:
        obs.RECORDER.clear()
    rec = harness.run_cell(cell, args.seed, args.seconds, trace=True,
                           device=None, sync=torch.cuda.synchronize)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "correct": harness.is_correct(rec.checks),
           "sgts_per_s": rec.window_sgts / rec.window_s,
           "window_sgts": rec.window_sgts,
           "mean_call_ms": 1e3 * sum(rec.latencies_s) / len(rec.latencies_s)}
    recorded = obs.RECORDER.spans if obs is not None else []
    if recorded:
        count = {}
        for name, _a, _b in recorded:
            count[name] = count.get(name, 0) + 1
        per = 1e6 * rec.window_sgts
        out["self_ms_per_sgt"] = dict(sorted(
            ((k, v / per) for k, v in obs.self_ns(recorded).items()),
            key=lambda kv: -kv[1]))
        out["spans"] = count
        out["spans_dropped"] = obs.RECORDER.dropped
        out["counters"] = {k: rec.delta(k) for k in (
            "steps", "rounds_total", "host_syncs", "executor.host_syncs",
            "host_reads")}
    idle, cover = spans.idle_by_span(rec), spans.idle_cover(rec)
    if idle is not None:
        out["idle_s_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
        out["window_s"] = rec.device_window.window_s
        out["busy_s"] = rec.device_window.busy_s
        out["longest_idle"] = longest_idle(cover)
        out["per_layer"] = {
            name: harness.metric_reader(name)(rec) for name in cell.per_layer}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
