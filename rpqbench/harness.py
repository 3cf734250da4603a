"""One run of one cell: build the persistent-query service of the cell's
configuration, warm it up on a prefix of the generated stream, drive it
closed loop for the run's seconds, check every answer against the plain
reference, and read the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` (its path is the ``file`` of the
configuration in BENCHMARK.json), the stream generator that it names,
``generators/<generator>.py`` with ``make(stream, seed, n_inserts)``,
``traffic/<mix>.json`` (and, where a mix needs code, ``traffic/<mix>.py``
with ``plan(traffic, config)`` returning keys merged into the mix), and
``metrics/<metric>.py`` with ``read(run)`` returning the metric's value or
None (nothing to read).

The loop is the paper's: one ``ingest`` call per sgt, in stream order, the
next call once the previous has returned with its results decoded. The
service is the program under test (``repro_torch``); the generator, the
reference, the roofline and the trace reading are the benchmark's own.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .generator import Sgt
from .reference import ServiceReference

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that no run may load (compared whole: the
#: port, ``repro_torch``, is not ``repro``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: the kernel counters of the program, read before and after the window
KERNEL_COUNTERS = (
    ("maxmin", "maxmin_matmul_fused"), ("maxmin", "maxmin_matmul"),
    ("ell", "ell_contract_rows"), ("ell", "ell_gather_contract"),
    ("rowsparse", "rowsparse_gather"),
    ("bucket", "bucket_maxmin_fused"), ("bucket", "bucket_maxmin"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: Dict[str, dict]          # name -> BENCHMARK.json entry
    per_layer: Dict[str, dict]


def forbidden_loaded(modules) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload``: its configuration, traffic mix and the
    metrics it reports, each found by name."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    planner = BENCH_DIR / "traffic" / f"{w['traffic']}.py"
    if planner.exists():
        traffic.update(_load_module(planner).plan(traffic, config))

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        metrics={m["name"]: m for m in bench["end_to_end"] if applies(m)},
        per_layer={m["name"]: m for m in bench["per_layer"] if applies(m)})


def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "rpqbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return _load_module(BENCH_DIR / "metrics" / f"{name}.py").read


# ---------------------------------------------------------------------------
# the stream and the queries
# ---------------------------------------------------------------------------


def make_stream(config: dict, seed: int, n_inserts: int) -> List[Sgt]:
    """The cell's stream from ``seed``, ``n_inserts`` inserts and the
    deletes among them, in timestamp order: the ``make`` of
    ``generators/<name>.py``, ``name`` the configuration's
    ``stream.generator``, given the configuration's ``stream``."""
    st = config["stream"]
    path = BENCH_DIR / "generators" / f"{st['generator']}.py"
    if not path.is_file():
        raise ValueError(f"unknown generator {st['generator']!r}: no {path}")
    return _load_module(path).make(st, seed, n_inserts)


def founding_queries(config: dict) -> List[Tuple[str, str, bool]]:
    """(name, expression, simple) of the queries registered before the
    stream starts."""
    out = [(name, expr, False) for name, expr in config["queries"].items()]
    out += [(f"{name}_simple", config["queries"][name], True)
            for name in config.get("simple_lanes", ())]
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunRecord:
    """What a run leaves for the metric readers (``metrics/*.py``)."""

    cell: Cell
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    window_sgts: int = 0
    memory_peak_bytes: int = 0
    counters_before: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters_after: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the service's per-query latency list lengths when the window opened
    latency_marks: Dict[str, int] = dataclasses.field(default_factory=dict)
    service: object = None
    device_window: object = None          # trace.DeviceWindow in traced runs
    launches: Dict[str, list] = dataclasses.field(default_factory=dict)
    #: the most edges the retained graph held at any event of the window
    present_edges_max: int = 0
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    failed: int = 0

    def delta(self, key: str) -> float:
        return self.counters_after.get(key, 0) - self.counters_before.get(key, 0)


def dense_group(svc):
    """The service's dense group (one ``BatchedDenseRPQEngine``)."""
    from repro_torch.core.engine import BatchedDenseRPQEngine

    for eng in svc.queries.values():
        if isinstance(eng, BatchedDenseRPQEngine):
            return eng
    raise RuntimeError("the service holds no dense group")


def program_counters(svc) -> Dict[str, float]:
    """The program's own counters: executor, engine, frontier and kernel
    launches (reading them flushes the executor's queued counts)."""
    import importlib

    g = dense_group(svc)
    ex = g.executor
    out = {"steps": ex.steps, "rounds_total": ex.rounds_total,
           "query_rounds_total": ex.query_rounds_total,
           "unmasked_query_rounds_total": ex.unmasked_query_rounds_total,
           "host_syncs": g.host_syncs, "executor.host_syncs": ex.host_syncs,
           "host_reads": g.host_reads,
           "ell_contractions_total": ex.ell_contractions_total,
           "q_cap": g.q_cap, "n_slots": g.n_slots, "k": g.k}
    if ex.frontier != "off":
        for key, val in ex.frontier_stats.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                out[f"frontier.{key}"] = val
    for mod, fn in KERNEL_COUNTERS:
        f = getattr(importlib.import_module(f"repro_torch.kernels.{mod}.{mod}"), fn)
        out[f"launches.{fn}"] = f.launches
    return out


class LaunchRecorder:
    """Records each B1 and B5 launch's operand shapes on the main path
    (the contraction layer's calls into the kernels), host-side only.
    B1's feed ``b1.roofline_pct``; B5's are kept for a reader of B5's
    share, which is left out until its bound holds (PERF.md, Open
    questions)."""

    def __init__(self):
        import repro_torch.core.contraction as contraction

        self.mod = contraction
        self.launches: Dict[str, list] = {"b1": [], "b5": []}
        self.saved = {}

    def __enter__(self):
        mod, rec = self.mod, self.launches
        b1, b5 = mod.maxmin_matmul_fused, mod.ell_contract_rows
        self.saved = {"maxmin_matmul_fused": b1, "ell_contract_rows": b5}

        def b1_rec(a, b):
            if a.device.type == "cuda":
                j, m, k = a.shape
                rec["b1"].append({"j": j, "m": m, "k": k, "n": b.shape[2],
                                  "itemsize": a.element_size()})
            return b1(a, b)

        def b5_rec(d, idx, ts, labs, src, dst, lab, sts):
            if d.device.type == "cuda":
                j, m, u = d.shape
                rec["b5"].append({"j": j, "m": m, "u": u, "e": idx.shape[2],
                                  "n_labels": idx.shape[0], "ring": src.shape[0]})
            return b5(d, idx, ts, labs, src, dst, lab, sts)

        mod.maxmin_matmul_fused = b1_rec
        mod.ell_contract_rows = b5_rec
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def build_service(config: dict, device):
    from repro_torch.streaming.service import PersistentQueryService

    sv = config["service"]
    return PersistentQueryService(
        window=float(sv["window"]), slide=float(sv["slide"]),
        frontier=sv.get("frontier", "off"),
        frontier_cap=int(sv.get("frontier_cap", 32)),
        adj_layout=sv.get("adj_layout", "dense"), ell_cap=int(sv.get("ell_cap", 8)),
        dist_layout=sv.get("dist_layout", "dense"),
        dist_cap=int(sv.get("dist_cap", 16)), device=device)


def _warm_enough(traffic: dict, frontier_stats: Optional[Callable], start_ts: float,
                 ts: float, boundaries: int, deletes: int) -> bool:
    """The mix's warm-up conditions; the frontier's apply where the
    configuration runs one (``frontier_stats`` reads its counters)."""
    warm = traffic["warmup"]
    if ts - start_ts < float(warm.get("min_stream_s", 0.0)):
        return False
    if boundaries < int(warm.get("min_slide_boundaries", 0)):
        return False
    need = set(warm.get("require", ()))
    if "delete" in need and deletes == 0:
        return False
    if frontier_stats is not None and need & {"frontier_fallback", "frontier_delete"}:
        fs = frontier_stats()
        if "frontier_fallback" in need and not fs["fallbacks"]:
            return False
        if "frontier_delete" in need and not fs["delete_dispatches"]:
            return False
    return True


def note(msg: str) -> None:
    print(f"rpqbench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False,
             device=None, t_start: Optional[float] = None,
             make_service: Optional[Callable] = None,
             max_window_sgts: Optional[int] = None,
             sync: Optional[Callable] = None) -> RunRecord:
    """One run (see the module docstring). ``device`` None is the card;
    ``make_service`` replaces the program (the tests' broken services);
    ``max_window_sgts`` ends the window early (tests). Returns the record,
    with ``checks`` and ``failed`` filled in; the caller reads metrics."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    rec = RunRecord(cell=cell, seed=seed, trace=trace)
    sync = sync or (lambda: None)
    window, slide = float(config["service"]["window"]), float(config["service"]["slide"])

    # the stream: enough inserts that the window never runs out
    prefix_inserts = int(traffic["warmup"].get("max_inserts", 0))
    rate_cap = float(config["max_sgts_per_s"])
    window_inserts = int(seconds * rate_cap) + 64
    if max_window_sgts is not None:
        window_inserts = min(window_inserts, max_window_sgts + 64)
    stream = make_stream(config, seed, prefix_inserts + window_inserts)
    note(f"set-up {time.perf_counter() - t_start:.3f} s: {len(stream)} sgts generated")

    svc = (make_service or (lambda cfg: build_service(cfg, device)))(config)
    batch = int(config["service"].get("batch_size", 1))
    n_slots = int(config["service"]["n_slots"])
    backend = config["service"].get("backend")     # None: kernels B1 and B5
    log: List[tuple] = []                  # what the reference replays

    for name, expr, simple in founding_queries(config):
        initial = svc.register(name, expr, engine="dense",
                               path_semantics="simple" if simple else "arbitrary",
                               n_slots=n_slots, batch_size=batch, backend=backend)
        log.append(("register", name, expr, simple, set(initial)))

    # warm-up: the prefix, one sgt a call, until the mix's conditions hold
    frontier_stats = None
    if make_service is None and config["service"].get("frontier", "off") != "off":
        def frontier_stats():
            return dense_group(svc).executor.frontier_stats
    i, boundaries, deletes = 0, 0, 0
    next_b = slide
    while True:
        s = stream[i]
        i += 1
        if s.ts >= next_b:
            boundaries += 1
            while next_b <= s.ts:
                next_b += slide
        deletes += s.op == "-"
        log.append(("event", s, svc.ingest([s])))
        if _warm_enough(traffic, frontier_stats, stream[0].ts, s.ts, boundaries, deletes):
            break
        if i >= len(stream) - window_inserts:
            raise RuntimeError("the warm-up never met the mix's conditions")
    note(f"set-up {time.perf_counter() - t_start:.3f} s: warm-up of {i} sgts over "
         f"{s.ts - stream[0].ts:.3f} stream s, {boundaries} slide boundaries, "
         f"{deletes} deletes")

    # the window
    record_latency = trace
    rec.counters_before = program_counters(svc) if make_service is None else {}
    if record_latency:
        rec.latency_marks = {n: len(q.latencies_us or ())
                             for n, q in svc.stats.items()}
    sync()
    recorder = LaunchRecorder() if trace and make_service is None else None
    prof = None
    spans: List[tuple] = []
    if trace:
        from .trace import start_profiler

        prof = start_profiler()
    if recorder is not None:
        recorder.__enter__()
    if make_service is None and device is None:
        import torch

        torch.cuda.reset_peak_memory_stats()
    w_first = len(log)
    lat = rec.latencies_s
    clock = time.perf_counter
    wall = time.time_ns
    t0 = clock()
    t0_wall = wall()
    rec.setup_s = t0 - t_start
    deadline = t0 + seconds
    try:
        while clock() < deadline:
            if max_window_sgts is not None and len(lat) >= max_window_sgts:
                break
            s = stream[i]
            i += 1
            a = wall() if trace else 0
            c0 = clock()
            report = svc.ingest([s], record_latency=record_latency)
            lat.append(clock() - c0)
            if trace:
                spans.append((s, a, wall()))
            log.append(("event", s, report))
        sync()
        rec.window_s = clock() - t0
        t_end_wall = wall()
    finally:
        if recorder is not None:
            recorder.__exit__(None, None, None)
    if make_service is None and device is None:
        import torch

        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if prof is not None:
        from .trace import DeviceWindow

        rec.device_window = DeviceWindow(prof, spans, t0_wall, t_end_wall, slide)
    if recorder is not None:
        rec.launches = recorder.launches
    rec.window_sgts = len(lat)
    note(f"window {rec.window_s:.3f} s: {rec.window_sgts} sgts; "
         f"reference check follows")
    rec.counters_after = program_counters(svc) if make_service is None else {}
    rec.service = svc

    # the reference, after the window
    rec.checks, rec.failed, rec.present_edges_max = check(log, window, slide, w_first)
    return rec


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------

CHECK_LIMITS = {
    "missing_pairs": 0, "extra_pairs": 0,
    "missing_invalidations": 0, "extra_invalidations": 0,
    "fallback_mismatches": 0, "initial_answer_mismatches": 0,
}


def _nonempty(d) -> Dict[str, set]:
    return {k: set(v) for k, v in d.items() if v}


def check(log: List[tuple], window: float, slide: float, w_first: int):
    """Replay the run's operations through the reference and compare
    every answer: returns ({name: {"value", "limit"}}, window operations
    answered wrong, the most edges retained at any window event)."""
    ref = ServiceReference(window, slide)
    counts = dict.fromkeys(CHECK_LIMITS, 0)
    failed = 0
    edges_max = 0
    for pos, entry in enumerate(log):
        wrong = 0
        if entry[0] == "register":
            _, name, expr, simple, got = entry
            want = ref.register(name, expr, simple)
            diff = len(want ^ got)
            counts["initial_answer_mismatches"] += diff
            wrong = diff
        else:
            _, s, report = entry
            new, inv, fbs = ref.event(s.ts, s.src, s.dst, s.label, s.op)
            got_new, got_inv = _nonempty(report), _nonempty(report.invalidated)
            for name in set(new) | set(got_new):
                a, b = new.get(name, set()), got_new.get(name, set())
                counts["missing_pairs"] += len(a - b)
                counts["extra_pairs"] += len(b - a)
                wrong += len(a ^ b)
            for name in set(inv) | set(got_inv):
                a, b = inv.get(name, set()), got_inv.get(name, set())
                counts["missing_invalidations"] += len(a - b)
                counts["extra_invalidations"] += len(b - a)
                wrong += len(a ^ b)
            if dict(report.fallbacks) != fbs:
                counts["fallback_mismatches"] += 1
                wrong += 1
            if pos >= w_first:
                edges_max = max(edges_max, len(ref.graph.edges))
        if pos >= w_first and wrong:
            failed += 1
    checks = {k: {"value": v, "limit": CHECK_LIMITS[k]} for k, v in counts.items()}
    return checks, failed, edges_max


def is_correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def result_line(cell: Cell, rec: RunRecord, device: dict) -> dict:
    """The run's result: ``correct``, ``attempted``, ``failed``, the
    metrics the run reports (end-to-end, or per-layer when traced) that
    found something to read, ``device``, ``breakdown`` when traced, and
    ``checks`` last."""
    wanted = cell.per_layer if rec.trace else cell.metrics
    metrics = {}
    for name, entry in wanted.items():
        value = metric_reader(name)(rec)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    device = dict(device, memory_peak_bytes=rec.memory_peak_bytes)
    line = {"correct": is_correct(rec.checks),
            "attempted": rec.window_sgts,
            "failed": rec.failed, "metrics": metrics, "device": device}
    if rec.trace and rec.device_window is not None:
        device["busy_s"] = rec.device_window.busy_s
        device["window_s"] = rec.device_window.window_s
        line["breakdown"] = rec.device_window.breakdown()
    line["checks"] = rec.checks
    return line
