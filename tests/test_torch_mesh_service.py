"""The port's service on the mesh executor, on the CPU: ``executor="mesh",
device="cpu"`` (a 1x1 grid) and a ``MeshExecutor`` over a 2x2 grid of
repeated CPU devices against the local executor per ingest call, with
``async_decode`` off and on (tests/test_executor.py:198-212), and once
against the JAX package's local service; checkpoints across executors
(mesh -> local, local -> mesh, and a JAX local snapshot restored on the
port's mesh, tests/test_executor.py:294); and the supervised service on
the mesh, dense and sparse (tests/test_supervisor.py's ``mesh-dense`` and
``mesh-sparse``): the chaos run's streams equal the clean run's. Tolerance
0.
"""
import tempfile

import pytest
import torch

from repro.streaming.service import PersistentQueryService as JaxService
from repro.streaming.stream import SGT as JaxSGT
from repro.streaming.stream import Stream as JaxStream
from repro_torch.distributed.executor import MeshExecutor
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import Stream
from repro_torch.streaming.supervisor import FaultPlan, ServiceSupervisor

WINDOW, SLIDE = 20.0, 2.0
NAMES = ["arb", "plus", "smp"]
SPARSE = dict(frontier="auto", frontier_cap=16, adj_layout="ell", ell_cap=6,
              dist_layout="row_sparse", dist_cap=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _register(svc):
    svc.register("arb", "a2q . c2a*", engine="dense", n_slots=32)
    svc.register("plus", "(a2q | c2a)+", engine="dense", n_slots=32)
    svc.register("smp", "(a2q | c2a | c2q)*", engine="dense",
                 path_semantics="simple", n_slots=32)
    return svc


def _grid(**kw):
    return MeshExecutor(["cpu"] * 4, model_axis=2, **kw)


def _service(executor="local", **kw):
    """``executor``: "local", "mesh" or "grid" (a 2x2 MeshExecutor)."""
    ex = _grid(**{k: v for k, v in kw.items() if k in SPARSE}) \
        if executor == "grid" else executor
    return _register(PersistentQueryService(window=WINDOW, slide=SLIDE,
                                            executor=ex, device="cpu", **kw))


def _tuples():
    return list(with_deletions(so_like(20, 90, seed=13), ratio=0.05, seed=7))


def _assert_reports_equal(tag, ra, rb):
    for name in NAMES:
        assert ra[name] == rb[name], (tag, name)
        assert ra.invalidated[name] == rb.invalidated[name], (tag, name)
    assert ra.fallbacks == rb.fallbacks, tag
    assert ra.deletions == rb.deletions, tag


@pytest.mark.parametrize("executor", ["mesh", "grid"])
@pytest.mark.parametrize("async_decode", [False, True])
def test_service_mesh_executor_matches_local(async_decode, executor):
    tuples = _tuples()
    svc_l = _service("local")
    svc_m = _service(executor, async_decode=async_decode)
    assert isinstance(svc_m.queries["arb"].executor, MeshExecutor)
    for i in range(0, len(tuples), 23):
        _assert_reports_equal(i, svc_l.ingest(Stream(tuples[i:i + 23])),
                              svc_m.ingest(Stream(tuples[i:i + 23])))
    for name in NAMES:
        assert svc_l.results(name) == svc_m.results(name), name


def test_service_mesh_grid_matches_jax_local_service():
    """The 2x2 mesh's service against the JAX package's local service,
    report for report over two ingest calls."""
    tuples = _tuples()
    half = len(tuples) // 2
    js = _register(JaxService(window=WINDOW, slide=SLIDE))
    ts = _service("grid")
    for part in (tuples[:half], tuples[half:]):
        jpart = [JaxSGT(s.ts, s.src, s.dst, s.label, s.op) for s in part]
        _assert_reports_equal(part[0].ts, js.ingest(JaxStream(jpart)),
                              ts.ingest(Stream(part)))
    for name in NAMES:
        assert ts.results(name) == js.results(name), name


@pytest.mark.parametrize("writer,reader", [("local", "mesh"), ("mesh", "local"),
                                           ("grid", "local"), ("local", "grid")])
def test_checkpoint_cross_restore_between_executors(writer, reader):
    """A checkpoint written under one executor restores under the other
    (state is saved logically, placed by the restoring executor) and the
    tail equals the uninterrupted run's."""
    tuples = _tuples()
    half = len(tuples) // 2
    svc = _service(writer)
    svc.ingest(Stream(tuples[:half]))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.snapshot(ckpt_dir, step=half)
        mid = {name: svc.results(name) for name in NAMES}
        tail = svc.ingest(Stream(tuples[half:]))
        svc2 = _service(reader)
        assert svc2.restore(ckpt_dir) == half
        for name in NAMES:
            assert svc2.results(name) == mid[name], name
        _assert_reports_equal("tail", tail, svc2.ingest(Stream(tuples[half:])))
        for name in NAMES:
            assert svc2.results(name) == svc.results(name), name


def test_jax_local_snapshot_restores_on_port_mesh():
    tuples = _tuples()
    half = len(tuples) // 2
    jtuples = [JaxSGT(s.ts, s.src, s.dst, s.label, s.op) for s in tuples]
    js = _register(JaxService(window=WINDOW, slide=SLIDE))
    js.ingest(JaxStream(jtuples[:half]))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        js.snapshot(ckpt_dir, step=half)
        jtail = js.ingest(JaxStream(jtuples[half:]))
        ts = _service("grid")
        assert ts.restore(ckpt_dir) == half
        _assert_reports_equal("tail", jtail, ts.ingest(Stream(tuples[half:])))
    for name in NAMES:
        assert ts.results(name) == js.results(name), name


FAULTS = dict(crash_before_dispatch=[3], crash_after_dispatch=[7],
              crash_during_replay=[9],
              crash_mid_snapshot={1: "shards", 2: "manifest", 3: "rename"},
              slow_dispatch={5: 0.001}, transient_errors={6: 2})


@pytest.mark.parametrize("cfg", ["mesh-dense", "mesh-sparse"])
def test_supervised_mesh_chaos_equals_clean(cfg):
    """Every fault point on the mesh (a 2x2 grid): the chaos run's result
    and invalidation streams and final results equal the clean run's."""
    options = SPARSE if cfg == "mesh-sparse" else {}

    def make(**extra):
        kw = {**options, **extra}
        return _service("grid", **kw)

    # tests/test_torch_supervisor.py's stream: 15 batches of 8, so every
    # scheduled fault point is reached
    tuples = list(with_deletions(so_like(24, 110, seed=13), ratio=0.04, seed=7))
    with tempfile.TemporaryDirectory() as d:
        clean = ServiceSupervisor(make, d, batch_events=8, ckpt_every=4)
        clean_final = clean.run(list(tuples))
    with tempfile.TemporaryDirectory() as d:
        plan = FaultPlan(**FAULTS)
        sup = ServiceSupervisor(make, d, batch_events=8, ckpt_every=4,
                                fault_plan=plan, verify_replay=True)
        final = sup.run(list(tuples))
        assert plan.exhausted and sup.recoveries
        assert isinstance(sup.service.queries["arb"].executor, MeshExecutor)
    assert sup.result_stream() == clean.result_stream()
    assert sup.invalidation_stream() == clean.invalidation_stream()
    assert final == clean_final


def test_mesh_service_runs_on_the_card_by_default():
    """``executor="mesh"`` without a device means every CUDA card: without
    one the dense group cannot be built (no fallback to the CPU)."""
    def build():
        svc = _register(PersistentQueryService(window=WINDOW, slide=SLIDE,
                                               executor="mesh"))
        svc.ingest(Stream(_tuples()[:4]))
        return svc.queries["arb"].executor

    if torch.cuda.is_available():
        ex = build()
        assert ex.device.type == "cuda"
        assert ex.n_shards * ex.n_model == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
