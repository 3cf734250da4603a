"""The port's span recorder (``repro_torch.obs``): off it records nothing;
on it nests spans, gives self times and bounds its buffer; and a traced
CPU service run of each benchmark configuration's queries, dense and
frontier + ELL, at a small ``n_slots``: one ``executor.round`` span a
closure round, one ``sync.*`` span a counted blocking read, and the same
reports as an untraced run."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.device import device_get
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService, QueryStats

ROOT = Path(__file__).resolve().parents[1]
LAYERS = ("service.", "engine.", "executor.", "sync.")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread, so the test workers do
    not spin-wait against each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def recorder():
    """The process's recorder, emptied before and after the test."""
    obs.RECORDER.clear()
    yield obs.RECORDER
    obs.RECORDER.clear()


def test_off_records_nothing(recorder):
    assert obs.on is False
    device_get(torch.ones(3), "test")
    svc, _ = _service("so-table2-dense-2048", n_slots=16)
    for s in list(with_deletions(so_like(16, 30, seed=3), 0.1, seed=1)):
        svc.ingest([s])
    assert recorder.spans == [] and recorder.dropped == 0
    assert obs.on is False


def test_pieces_and_self_times_of_nested_spans():
    spans = [
        ("service.ingest", 0, 100),
        ("engine.intern", 0, 10),             # shares its parent's start
        ("executor.dispatch", 10, 60),        # starts where its sibling ends
        ("executor.round", 15, 25),
        ("sync.closure", 25, 30),
        ("executor.round", 30, 40),
        ("sync.closure", 40, 40),             # empty
        ("engine.decode", 70, 90),
        ("sync.decode", 80, 95),              # outlives its parent: cut at 90
        ("service.ingest", 200, 210),         # a second call, after a gap
    ]
    assert obs.innermost(reversed(spans)) == [
        ("engine.intern", 0, 10), ("executor.dispatch", 10, 15),
        ("executor.round", 15, 25), ("sync.closure", 25, 30),
        ("executor.round", 30, 40), ("executor.dispatch", 40, 60),
        ("service.ingest", 60, 70), ("engine.decode", 70, 80),
        ("sync.decode", 80, 90), ("service.ingest", 90, 100),
        ("service.ingest", 200, 210)]
    self_ns = obs.self_ns(spans)
    assert self_ns == {"service.ingest": 30, "engine.intern": 10,
                       "executor.dispatch": 25, "executor.round": 20,
                       "sync.closure": 5, "engine.decode": 10,
                       "sync.decode": 10}
    # self times add up to the time the outermost spans cover
    assert sum(self_ns.values()) == 100 + 10


def test_recording_nests_live_spans(recorder):
    with obs.recording():
        assert obs.on is True
        outer = obs.now()
        inner = obs.now()
        device_get(torch.arange(4), "test")
        obs.add("engine.decode", inner)
        obs.add("service.ingest", outer)
    assert obs.on is False
    (read, a0, a1), (child, b0, b1), (parent, c0, c1) = recorder.spans
    assert (read, child, parent) == ("sync.test", "engine.decode", "service.ingest")
    assert c0 <= b0 <= a0 <= a1 <= b1 <= c1
    assert obs.self_ns(recorder.spans) == {
        "service.ingest": (c1 - c0) - (b1 - b0),
        "engine.decode": (b1 - b0) - (a1 - a0), "sync.test": a1 - a0}


def test_recorder_bounds_its_buffer():
    rec = obs.Recorder(cap=3)
    for k in range(5):
        rec.add(f"engine.span{k}", obs.now())
    assert [s[0] for s in rec.spans] == ["engine.span0", "engine.span1",
                                         "engine.span2"]
    assert rec.dropped == 2
    rec.clear()
    assert rec.spans == [] and rec.dropped == 0
    rec.spans[:] = [("engine.a", 0, 5), ("engine.b", 4, 9), ("engine.c", 10, 12)]
    assert rec.between(4, 10) == [("engine.b", 4, 9)]


def test_p99_is_read_from_the_latencies():
    st = QueryStats(latencies_us=[float(x) for x in range(200, 0, -1)])
    assert st.p99_us == 199.0
    assert QueryStats(latencies_us=[]).p99_us == 0.0
    assert not hasattr(st, "wall_s")


def _config(name):
    return json.loads((ROOT / "rpqbench" / "configs" / f"{name}.json").read_text())


def _service(config_name, n_slots):
    """The configuration's service and queries (its simple lanes too), at
    ``n_slots`` vertex slots, on the CPU."""
    cfg = _config(config_name)
    sv = cfg["service"]
    svc = PersistentQueryService(
        window=sv["window"], slide=sv["slide"], frontier=sv.get("frontier", "off"),
        frontier_cap=sv.get("frontier_cap", 32),
        adj_layout=sv.get("adj_layout", "dense"), ell_cap=sv.get("ell_cap", 8),
        dist_layout=sv.get("dist_layout", "dense"), device="cpu")
    for name, expr in cfg["queries"].items():
        svc.register(name, expr, n_slots=n_slots, batch_size=sv["batch_size"])
    for name in cfg["simple_lanes"]:
        svc.register(f"{name}_simple", cfg["queries"][name], path_semantics="simple",
                     n_slots=n_slots, batch_size=sv["batch_size"])
    return svc, cfg


def _reports(report):
    return (dict(report), report.invalidated, report.fallbacks,
            report.frontier_stats, report.deletions)


@pytest.mark.parametrize("config", ["so-table2-dense-2048", "so-table2-ell-8192"])
def test_traced_service_counts_rounds_and_reads(recorder, config):
    n_slots = 48
    plain, cfg = _service(config, n_slots)
    traced, _ = _service(config, n_slots)
    rate = cfg["stream"]["rate"]
    stream = list(with_deletions(so_like(n_slots, 150, seed=11, rate=rate),
                                 0.05, seed=2))
    assert any(s.op == "-" for s in stream)
    cut = len(stream) // 2
    for s in stream[:cut]:                 # warm-up: untraced on both sides
        assert _reports(traced.ingest([s])) == _reports(plain.ingest([s]))
    group = traced.queries["Q1"]
    ex = group.executor
    rounds0, syncs0, reads0 = ex.rounds_total, ex.host_syncs, group.host_reads
    for s in stream[cut:]:
        assert _reports(traced.ingest([s], record_latency=True)) == \
            _reports(plain.ingest([s]))
    assert obs.on is False and recorder.dropped == 0
    spans = recorder.spans
    count = {}
    for name, a, b in spans:
        assert name.startswith(LAYERS) and a <= b, name
        count[name] = count.get(name, 0) + 1
    calls = [(a, b) for name, a, b in spans if name == "service.ingest"]
    assert len(calls) == len(stream) - cut
    # every span lies inside a call
    starts = sorted(calls)
    for name, a, b in spans:
        assert any(c0 <= a and b <= c1 for c0, c1 in starts), name
    assert count["executor.round"] == ex.rounds_total - rounds0 > 0
    assert count.get("sync.closure", 0) == (ex.host_syncs - syncs0
                                            - count.get("sync.frontier", 0)
                                            - count.get("sync.plan", 0))
    assert count["sync.decode"] + count.get("sync.probe", 0) == \
        group.host_reads - reads0
    if cfg["service"].get("frontier", "off") != "off":
        assert count["sync.plan"] == count["executor.plan"] > 0
    else:
        assert count["sync.closure"] == ex.host_syncs - syncs0 > 0
    assert {"service.expire", "engine.intern", "engine.decode",
            "executor.upload", "executor.emit", "executor.dispatch"} <= set(count)
    for name in traced.stats:
        assert traced.stats[name].results == plain.stats[name].results


def _inside(spans, inner, outer):
    """Each ``inner`` span lies inside an ``outer`` one."""
    outs = [(a, b) for name, a, b in spans if name == outer]
    return all(any(a0 <= a and b <= b0 for a0, b0 in outs)
               for name, a, b in spans if name == inner)


def test_repack_waits_only_in_its_reads(recorder):
    from repro_torch.core.sparse_adj import (
        ell_live_entries, ell_to_dense, pack_ell_dense)

    svc, cfg = _service("so-table2-ell-8192", n_slots=32)
    rate = cfg["stream"]["rate"]
    for s in with_deletions(so_like(32, 120, seed=5, rate=rate), 0.05, seed=4):
        svc.ingest([s])
    ex = svc.queries["Q1"].executor
    ell = ex._arrays.adj
    assert int(device_get(ell.spill_ptr)) > 0          # the ring holds edges
    dense = ell_to_dense(ell)
    keys, ts = ell_live_entries(ell)
    flat = dense.reshape(-1)
    want = torch.nonzero(flat > float("-inf")).reshape(-1)
    assert torch.equal(keys, want) and torch.equal(ts, flat[want])
    with obs.recording():
        ex._repack_ell()
    names = [name for name, _a, _b in recorder.spans]
    assert sorted(names) == ["executor.repack"] + ["sync.repack"] * 3
    assert _inside(recorder.spans, "sync.repack", "executor.repack")
    packed = pack_ell_dense(dense, ex.ell_cap, ex.spill_cap)
    for got, ref in zip(ex._arrays.adj, packed):
        assert torch.equal(got, ref)


def test_table_rebuild_waits_only_in_its_uploads(recorder):
    svc, _ = _service("so-table2-dense-2048", n_slots=16)
    group = svc.queries["Q1"]
    with obs.recording():
        group._rebuild_tables()
    names = {name for name, _a, _b in recorder.spans}
    assert names == {"engine.tables", "sync.tables"}
    assert _inside(recorder.spans, "sync.tables", "engine.tables")
