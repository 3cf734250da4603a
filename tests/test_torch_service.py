"""The port's persistent-query service against the JAX package's: the
scenario of examples/streaming_service.py (mixed dense/reference engines,
both path semantics, 2% explicit deletions, two ingest calls) scaled down
and without the snapshot, compared report for report. Also: the RSPQ
fallback, the async-decode FIFO, adaptive batching, the frontier and ELL
options with their telemetry logs, the bucket backend, the executor
names (the mesh builds on the CPU when asked), and that importing the
port loads neither JAX nor ``repro``."""
import tempfile

import pytest
import torch

from repro.core.backend import BucketBackend as JaxBucket
from repro.streaming.service import PersistentQueryService as JaxService
from repro_torch.core.contraction import BucketBackend
from repro_torch.distributed.executor import MeshExecutor
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import Stream

from _torch_imports import assert_loads_neither_jax_nor_repro

REGS = [  # (name, expr, engine, path_semantics)
    ("notify", "a2q . c2a*", "dense", "arbitrary"),
    ("notify_simple", "a2q . c2a*", "dense", "simple"),
    ("chain_simple", "a2q . c2a* . c2q*", "dense", "simple"),
    ("reach", "(a2q | c2a | c2q)+", "dense", "arbitrary"),
    ("reach_ref", "(a2q | c2a)+", "reference", "arbitrary"),
]


def _services(backends=(None, None), **kw):
    """A JAX and a port service with REGS registered; ``backends`` are the
    dense queries' backends (default: each package's default)."""
    js = JaxService(window=20.0, slide=2.0, **kw)
    ts = PersistentQueryService(window=20.0, slide=2.0, device="cpu", **kw)
    jb = {} if backends[0] is None else {"backend": backends[0]}
    tb = {} if backends[1] is None else {"backend": backends[1]}
    for name, expr, engine, sem in REGS:
        js.register(name, expr, engine=engine, path_semantics=sem, n_slots=24, **jb)
        ts.register(name, expr, engine=engine, path_semantics=sem, n_slots=24, **tb)
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
    # the mesh executor is ported: on the CPU when the service says so
    mesh = PersistentQueryService(window=5.0, slide=1.0, executor="mesh",
                                  device="cpu")
    mesh.register("q", "a*")
    ex = mesh.queries["q"].executor
    assert isinstance(ex, MeshExecutor)
    assert ex.grid == [[torch.device("cpu")]]
    for name in ("sharded", "Mesh"):
        with pytest.raises(ValueError, match="unknown executor"):
            PersistentQueryService(window=5.0, slide=1.0, executor=name,
                                   device="cpu")
    PersistentQueryService(window=5.0, slide=1.0, frontier="auto",
                           adj_layout="ell", device="cpu")
    PersistentQueryService(window=5.0, slide=1.0, dist_layout="row_sparse",
                           device="cpu")
    for kw in ({"frontier": "sideways"}, {"adj_layout": "csr"},
               {"dist_layout": "sparse"}):
        with pytest.raises(ValueError):
            PersistentQueryService(window=5.0, slide=1.0, device="cpu", **kw)
    svc = PersistentQueryService(window=5.0, slide=1.0, device="cpu")
    # snapshot and restore are ported (tests/test_torch_checkpoint.py)
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d, step=4)
        assert PersistentQueryService(window=5.0, slide=1.0,
                                      device="cpu").restore(d) == 4
    # the bucket backend is ported: by name and as an instance
    svc.register("q", "a*", backend="mxu_bucket")
    svc.register("r", "b*", backend=BucketBackend(8))
    assert svc.queries["q"].backend == BucketBackend(8)


@pytest.mark.parametrize("adj_layout", ["ell", "dense"])
def test_frontier_service_report_for_report(adj_layout):
    """``frontier="auto"`` with a tiny capacity and adaptive batching over
    three ingest calls: IngestReports (with their per-call frontier
    telemetry), frontier_log, adjacency_log and batch_size_log equal."""
    kw = dict(frontier="auto", frontier_cap=2, adj_layout=adj_layout,
              ell_cap=2, adaptive_batch=True, max_batch=8)
    js, ts = _services(**kw)
    tuples = list(with_deletions(so_like(n_vertices=24, n_edges=150, seed=8),
                                 ratio=0.04, seed=3))
    for part in (tuples[:40], tuples[40:100], tuples[100:]):
        rj, rt = js.ingest(Stream(part)), ts.ingest(Stream(part))
        _assert_reports_equal(rj, rt)
        assert rt.frontier_stats == rj.frontier_stats
    _assert_services_equal(js, ts)
    assert ts.frontier_log == js.frontier_log != []
    assert ts.adjacency_log == js.adjacency_log
    assert ts.batch_size_log == js.batch_size_log
    assert (ts.adjacency_log != []) == (adj_layout == "ell")
    group = ts.queries["notify"]
    st = group.executor.frontier_stats
    assert st["fallbacks"] >= 1 and st["cap"] > 2 and st["delete_dispatches"] >= 1


@pytest.mark.parametrize("kw", [{}, {"frontier": "auto", "frontier_cap": 2,
                                   "adj_layout": "ell", "ell_cap": 2}])
def test_bucket_service_report_for_report(kw):
    """A service whose dense group runs the bucket backend against the JAX
    service with the reference's bucket backend: reports (new pairs,
    invalidations, fallbacks, deletions), results and stats equal."""
    js, ts = _services(backends=(JaxBucket(8, use_pallas=False), "mxu_bucket"),
                       **kw)
    tuples = list(with_deletions(so_like(n_vertices=24, n_edges=100, seed=5),
                                 ratio=0.04, seed=2))
    for part in (tuples[:50], tuples[50:]):
        _assert_reports_equal(js.ingest(Stream(part)), ts.ingest(Stream(part)))
    _assert_services_equal(js, ts)
    assert ts.queries["notify"].backend == BucketBackend(8)
    assert ts.frontier_log == js.frontier_log


def test_import_loads_neither_jax_nor_the_reference_package():
    assert_loads_neither_jax_nor_repro(
        "import repro_torch, repro_torch.core, "
        "repro_torch.streaming.service, repro_torch.kernels.maxmin.maxmin, "
        "repro_torch.kernels.ell.ell, repro_torch.core.sparse_adj, "
        "repro_torch.core.sparse_dist, "
        "repro_torch.kernels.rowsparse.rowsparse, "
        "repro_torch.kernels.bucket.bucket, repro_torch.kernels.bucket.ops, "
        "repro_torch.checkpoint.ckpt, repro_torch.streaming.wal, "
        "repro_torch.streaming.supervisor, repro_torch.distributed.fault, "
        "repro_torch.distributed.executor")
