"""The port's persistent-query service against the JAX package's: the
scenario of examples/streaming_service.py (mixed dense/reference engines,
both path semantics, 2% explicit deletions, two ingest calls) scaled down
and without the snapshot, compared report for report. Also: the RSPQ
fallback, the async-decode FIFO, adaptive batching, the options not yet
ported, and that importing the port loads neither JAX nor ``repro``."""
import subprocess
import sys
from pathlib import Path

import pytest

from repro.streaming.service import PersistentQueryService as JaxService
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import Stream

SRC = Path(__file__).resolve().parents[1] / "src"

REGS = [  # (name, expr, engine, path_semantics)
    ("notify", "a2q . c2a*", "dense", "arbitrary"),
    ("notify_simple", "a2q . c2a*", "dense", "simple"),
    ("chain_simple", "a2q . c2a* . c2q*", "dense", "simple"),
    ("reach", "(a2q | c2a | c2q)+", "dense", "arbitrary"),
    ("reach_ref", "(a2q | c2a)+", "reference", "arbitrary"),
]


def _services(**kw):
    js = JaxService(window=20.0, slide=2.0, **kw)
    ts = PersistentQueryService(window=20.0, slide=2.0, device="cpu", **kw)
    for name, expr, engine, sem in REGS:
        js.register(name, expr, engine=engine, path_semantics=sem, n_slots=24)
        ts.register(name, expr, engine=engine, path_semantics=sem, n_slots=24)
    return js, ts


def _assert_reports_equal(rj, rt):
    assert dict(rt) == dict(rj)
    assert rt.invalidated == rj.invalidated
    assert rt.fallbacks == rj.fallbacks
    assert rt.deletions == rj.deletions


def _assert_services_equal(js, ts):
    for name, *_ in REGS:
        assert ts.results(name) == js.results(name), name
        sj, st = js.stats[name], ts.stats[name]
        assert (st.tuples, st.results, st.conflicted) == \
            (sj.tuples, sj.results, sj.conflicted), name


@pytest.mark.parametrize("kw", [{}, {"async_decode": True, "async_depth": 2}])
def test_streaming_service_scenario_report_for_report(kw):
    stream = with_deletions(so_like(n_vertices=24, n_edges=120, seed=42),
                            ratio=0.02, seed=1)
    tuples = list(stream)
    half = len(tuples) // 2
    js, ts = _services(**kw)
    for part in (tuples[:half], tuples[half:]):
        _assert_reports_equal(js.ingest(Stream(part), record_latency=True),
                              ts.ingest(Stream(part), record_latency=True))
    _assert_services_equal(js, ts)
    # the conflicting simple-path lane fell back to the reference RSPQ
    assert "chain_simple" in ts._ref_engines
    assert ts.stats["chain_simple"].conflicted


def test_adaptive_batch_and_live_registration():
    js, ts = _services(adaptive_batch=True, max_batch=8)
    tuples = list(so_like(n_vertices=20, n_edges=150, seed=7))
    _assert_reports_equal(js.ingest(Stream(tuples[:90])),
                          ts.ingest(Stream(tuples[:90])))
    assert ts.register("late", "c2a . c2q*") == js.register("late", "c2a . c2q*")
    ts.deregister("notify")
    js.deregister("notify")
    _assert_reports_equal(js.ingest(Stream(tuples[90:])),
                          ts.ingest(Stream(tuples[90:])))
    assert ts.batch_size_log == js.batch_size_log != []
    assert ts.results("late") == js.results("late")


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        PersistentQueryService(window=5.0, slide=1.0, executor="mesh",
                               device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        PersistentQueryService(window=5.0, slide=1.0, frontier="auto",
                               device="cpu")
    svc = PersistentQueryService(window=5.0, slide=1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        svc.snapshot("unused", step=0)
    with pytest.raises(NotImplementedError, match="A10"):
        svc.restore("unused")
    with pytest.raises(NotImplementedError, match="B3"):
        svc.register("q", "a*", backend="mxu_bucket")


def test_import_loads_neither_jax_nor_the_reference_package():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.streaming.service, repro_torch.kernels.maxmin.maxmin; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
