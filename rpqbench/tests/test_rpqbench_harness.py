"""BENCHMARK.json keeps the contract's shape, and the harness finds each
cell's configuration, traffic mix and metric readers by name."""
import json
import re
from pathlib import Path

import pytest

from rpqbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rpqbench"] and BENCH["command"][1].startswith("rpqbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("rpqbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == workload)
    assert "warmup" in cell.traffic and "setup_s" in cell.metrics
    assert "sgts_per_s" in cell.metrics and cell.per_layer
    for name in list(cell.metrics) + list(cell.per_layer):
        assert callable(harness.metric_reader(name))


def test_every_metric_has_a_reader_and_every_file_a_metric():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "rpqbench" / "metrics").glob("*.py")}
    assert names == files


def test_a_new_cell_is_data_only(tmp_path):
    """A cell added as entries and data files needs no edit of the harness."""
    import shutil

    (tmp_path / "rpqbench").mkdir()
    for sub in ("configs", "traffic"):
        shutil.copytree(ROOT / "rpqbench" / sub, tmp_path / "rpqbench" / sub)
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "rpqbench/configs/so-table2-dense-2048.json").read_text())
    cfg["name"] = "so-table2-dense-1024"
    cfg["service"]["n_slots"] = cfg["stream"]["n_vertices"] = 1024
    (tmp_path / "rpqbench/configs/so-table2-dense-1024.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name=cfg["name"],
                                 file="rpqbench/configs/so-table2-dense-1024.json"))
    bench["workloads"].append({"name": "so-dense-1024.steady", "config": cfg["name"],
                               "traffic": "steady", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "so-dense-1024.steady")
    assert cell.config["service"]["n_slots"] == 1024
    assert "b1.roofline_pct" not in cell.per_layer     # listed by cell name


def test_the_stream_generator_is_found_by_name(tmp_path, monkeypatch):
    """A configuration names its generator; a new one is a new file."""
    import shutil

    from rpqbench.generator import so_like, with_deletions

    cfg = json.loads((ROOT / "rpqbench/configs/so-table2-dense-2048.json").read_text())
    st = dict(cfg["stream"], arrival_seed=None)
    got = harness.make_stream({"stream": st}, 7, 50)
    assert got == with_deletions(so_like(2048, 50, 7, 10.0), 0.02, 8)
    shutil.copytree(ROOT / "rpqbench" / "generators", tmp_path / "generators")
    (tmp_path / "generators" / "fixed.py").write_text(
        "from rpqbench.generator import Sgt\n\n\n"
        "def make(stream, seed, n_inserts):\n"
        "    return [Sgt(float(i), seed, i, stream['labels'][0]) for i in range(n_inserts)]\n")
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    got = harness.make_stream({"stream": dict(st, generator="fixed")}, 3, 4)
    assert [(s.ts, s.src, s.dst, s.label, s.op) for s in got] == [
        (float(i), 3, i, "a2q", "+") for i in range(4)]
    with pytest.raises(ValueError, match="unknown generator"):
        harness.make_stream({"stream": dict(st, generator="nope")}, 3, 4)
