"""The span readers (rpqbench/spans.py and the five metrics that use it) on
a synthetic run record with known spans and busy intervals, on a traced
CPU run of each cell cut small, and on a program without spans; on the
card, that a kernel launched inside a span lands inside it on the
profiler's clock and that every sync the card reports in 64 dispatches
of each cell's configuration, and in an ELL re-pack and a table rebuild,
falls inside a ``sync.*`` span."""
import json
import sys
import time
import types
import warnings
from pathlib import Path

import pytest

from rpqbench import harness, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = ("service.self_ms_per_sgt", "engine.host_ms_per_sgt",
                "executor.host_ms_per_sgt", "executor.sync_wait_ms_per_sgt")
SYNC_WARNING = "called a synchronizing CUDA operation"   # sync debug mode's text

#: two calls in a window [1000, 2000] ns, and spans outside it
SPANS = [
    ("service.ingest", 900, 1010),          # straddles the window's start
    ("engine.intern", 1000, 1050),
    ("executor.round", 1100, 1150),
    ("sync.closure", 1150, 1250),
    ("executor.dispatch", 1050, 1300),
    ("sync.decode", 1320, 1360),
    ("engine.decode", 1300, 1380),
    ("service.ingest", 1000, 1400),
    ("engine.intern", 1500, 1600),
    ("service.tail", 1800, 1900),
    ("service.ingest", 1500, 1900),
    ("service.ingest", 2100, 2200),         # after the window
]
BUSY = [(1100, 1160), (1400, 1500), (1950, 2050)]


@pytest.fixture
def recorded():
    """SPANS in the program's recorder (emptied after the test)."""
    from repro_torch import obs

    obs.RECORDER.clear()
    obs.RECORDER.spans.extend(SPANS)
    yield obs.RECORDER
    obs.RECORDER.clear()


def synthetic_run(aligned=True, events=True):
    w = types.SimpleNamespace(t0_ns=1000, t1_ns=2000, window_s=1e-6, busy=BUSY,
                              aligned=aligned,
                              events=[("k", a, b) for a, b in BUSY] if events else [])
    return types.SimpleNamespace(device_window=w, window_sgts=2)


def read(name, run):
    return harness.metric_reader(name)(run)


def test_self_times_by_layer(recorded):
    run = synthetic_run()
    # self ns: service.ingest 20 + 200, service.tail 100; engine.intern
    # 50 + 100, engine.decode 40; executor.dispatch 100, executor.round 50;
    # sync.closure 100, sync.decode 40; two sgts
    assert read("service.self_ms_per_sgt", run) == pytest.approx(320 / 2e6)
    assert read("engine.host_ms_per_sgt", run) == pytest.approx(190 / 2e6)
    assert read("executor.host_ms_per_sgt", run) == pytest.approx(150 / 2e6)
    assert read("executor.sync_wait_ms_per_sgt", run) == pytest.approx(140 / 2e6)
    # together they are the calls' time
    assert sum(read(m, run) for m in SPAN_METRICS) == pytest.approx(800 / 2e6)


def test_idle_time_by_innermost_span(recorded):
    run = synthetic_run()
    idle = spans.idle_by_span(run)
    assert idle == pytest.approx({
        "engine.intern": 150e-9, "executor.dispatch": 100e-9,
        "sync.closure": 90e-9, "engine.decode": 40e-9, "sync.decode": 40e-9,
        "service.ingest": 220e-9, "service.tail": 100e-9, spans.NO_SPAN: 50e-9})
    # the window's idle time: 1000 ns less 60 + 100 + 50 busy
    assert sum(idle.values()) == pytest.approx(790e-9)
    # gap by gap: the first runs from the window's start to the first busy
    # interval, under engine.intern and then executor.dispatch
    cover = spans.idle_cover(run)
    assert [(a, b) for a, b, _ in cover] == [(1000, 1100), (1160, 1400),
                                             (1500, 1950)]
    assert cover[0][2] == {"engine.intern": 50, "executor.dispatch": 50}
    # host-bound: idle under a span that is not sync.*
    assert read("device.idle_host_bound_pct", run) == pytest.approx(61.0)
    assert read("device.idle_host_bound_pct", synthetic_run(aligned=False)) is None
    assert read("device.idle_host_bound_pct", synthetic_run(events=False)) is None


def test_nothing_to_read_without_spans(recorded, monkeypatch):
    import repro_torch

    untraced = types.SimpleNamespace(device_window=None, window_sgts=2)
    for name in SPAN_METRICS + ("device.idle_host_bound_pct",):
        assert read(name, untraced) is None
    # a program without the recorder, as one from before it
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for name in SPAN_METRICS + ("device.idle_host_bound_pct",):
        assert read(name, synthetic_run()) is None


@pytest.mark.parametrize("workload", CELLS)
def test_traced_cpu_run_attributes_the_calls(small_cell, workload):
    from repro_torch import obs

    obs.RECORDER.clear()
    cell = small_cell(workload, n_slots=48)
    rec = harness.run_cell(cell, 2**31 + 11, 1e9, trace=True, device="cpu",
                           max_window_sgts=30)
    try:
        line = harness.result_line(cell, rec, {"platform": "cpu", "kind": "x",
                                               "count": 1})
        assert line["correct"] is True
        got = {m: line["metrics"][m]["value"] for m in SPAN_METRICS}
        mean_call_ms = 1e3 * sum(rec.latencies_s) / len(rec.latencies_s)
        assert 0.95 * mean_call_ms <= sum(got.values()) <= 1.01 * mean_call_ms
        window = spans.window_spans(rec)
        loose = obs.self_ns(window)["service.ingest"] / 1e6 / rec.window_sgts
        assert loose < 0.1 * mean_call_ms
        # no CUDA events on the CPU: nothing to put idle time down to
        assert "device.idle_host_bound_pct" not in line["metrics"]
    finally:
        obs.RECORDER.clear()


@pytest.mark.gpu
def test_a_kernel_lands_inside_its_span_on_the_profilers_clock(card):
    import torch

    from repro_torch import obs
    from repro_torch.device import device_get
    from rpqbench import trace

    x = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    obs.RECORDER.clear()
    prof = trace.start_profiler()
    with obs.recording():
        t0 = obs.now()
        torch.cuda._sleep(2_000_000)
        device_get(x, "test")                 # waits for the sleep
        obs.add("engine.test", t0)
    prof.stop()
    events = trace._device_events(prof)
    (_, s0, s1) = next(s for s in obs.RECORDER.spans if s[0] == "engine.test")
    obs.RECORDER.clear()
    assert max(b - a for _n, a, b in events) >= 500_000, events
    for name, a, b in events:
        assert s0 <= a <= b <= s1, (name, a - s0, s1 - b)


def _window_with_a_delete_and_a_boundary(stream, first, n, slide):
    for start in range(first, len(stream) - n):
        part = stream[start:start + n]
        if (any(s.op == "-" for s in part)
                and int(part[0].ts // slide) != int(part[-1].ts // slide)):
            return start
    raise RuntimeError("no window with a delete and a slide boundary")


def _syncs_outside_sync_spans(work):
    """Run ``work()`` under the sync debug mode; return the syncs it made
    (as their sites in the program) and those outside every ``sync.*``
    span it recorded."""
    import torch

    from repro_torch import obs

    torch.cuda.synchronize()
    obs.RECORDER.clear()
    syncs = []

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            frame, site = sys._getframe(1), None
            while frame is not None and site is None:
                path = frame.f_code.co_filename
                if "repro_torch" in path and not path.endswith("device.py"):
                    site = f"{Path(path).name}:{frame.f_lineno}"
                frame = frame.f_back
            syncs.append((time.time_ns(), site))

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    waits = [(a, b) for name, a, b in obs.RECORDER.spans if name.startswith("sync.")]
    obs.RECORDER.clear()
    return syncs, [site for t, site in syncs
                   if not any(a <= t <= b for a, b in waits)]


def _warm_service(workload, n_warm_intervals=2, n=64):
    """The cell's service fed up to a stretch of ``n`` sgts that holds a
    delete and a slide boundary: ``(svc, that stretch)``."""
    cell = harness.load_cell(ROOT, workload)
    config = cell.config
    slide = float(config["service"]["slide"])
    rate = float(config["stream"]["rate"])
    stream = harness.make_stream(config, 2**31 + 7, int(12 * rate) + n)
    warm = int(n_warm_intervals * slide * rate)
    start = _window_with_a_delete_and_a_boundary(stream, warm, n, slide)
    svc = harness.build_service(config, None)
    n_slots = int(config["service"]["n_slots"])
    for name, expr, simple in harness.founding_queries(config):
        svc.register(name, expr, path_semantics="simple" if simple else "arbitrary",
                     n_slots=n_slots, batch_size=1)
    for s in stream[:start]:
        svc.ingest([s])
    return svc, stream[start:start + n]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_every_sync_falls_inside_a_sync_span(card, workload):
    svc, part = _warm_service(workload)

    def work():
        for s in part:
            svc.ingest([s], record_latency=True)

    syncs, outside = _syncs_outside_sync_spans(work)
    assert syncs and not outside, (len(syncs), outside)


@pytest.mark.gpu
def test_repack_and_table_syncs_fall_inside_sync_spans(card):
    """The ELL re-pack and the table rebuild, which 64 dispatches may not
    reach: only their gated reads and uploads wait on the card."""
    from repro_torch import obs

    svc, _part = _warm_service("so-ell-8192.steady", n=8)
    group = harness.dense_group(svc)

    def work():
        with obs.recording():
            group.executor._repack_ell()
            group._rebuild_tables()

    syncs, outside = _syncs_outside_sync_spans(work)
    assert syncs and not outside, (len(syncs), outside)
