"""The port's checkpoints (``repro_torch.checkpoint.ckpt`` and the
service's ``snapshot``/``restore``) against the JAX package's, on the CPU:
the same service state gives the same manifest and npz members in both
packages, a checkpoint either package wrote restores in the other with the
same results afterwards (dense, and frontier + ELL + row-sparse), the
port's restore of a JAX-written checkpoint imports neither JAX nor
``repro``, pickled reference engines and RSPQ fallbacks cross over, and a
snapshot taken after a simple lane fell back cannot be restored into a
service that registers the lane as dense again, in either package. Then
the reference's cases of tests/test_fault.py,
tests/test_query_churn.py::test_service_checkpoint_records_live_query_set
and the interner and results round trips of
tests/test_engine_regressions.py, on the port; the bucket backend; and
restores across slot and lane capacities. Tolerance 0 throughout: max and
min never reassociate.
"""
import collections
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.streaming.service import PersistentQueryService as JaxService
from repro.streaming.stream import SGT as JaxSGT
from repro.streaming.stream import Stream as JaxStream
from repro_torch.checkpoint import ckpt
from repro_torch.core.automaton import compile_query
from repro_torch.core.engine import DenseRPQEngine
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService, RSPQFallback
from repro_torch.streaming.stream import SGT, Stream

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many tiny tensor ops; with one intra-op thread per
    process they do not spin-wait against the other test workers for the
    cores (under ``-n 6`` they ran up to 100x slower with the default)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
WINDOW, SLIDE = 20.0, 2.0
QUERY_NAMES = ["d_arb", "d_plus", "d_smp", "r_arb"]
LAYOUTS = {
    "dense": {},
    "sparse": dict(frontier="on", frontier_cap=16, adj_layout="ell", ell_cap=6,
                   dist_layout="row_sparse", dist_cap=24),
}
# three edges that give "a2q . c2a* . c2q*" a conflict: x reaches z after
# a2q (suffix c2a* . c2q*) and after a2q . c2q (suffix c2q*)
CONFLICT = [(0, 1, "a2q"), (1, 2, "c2q"), (0, 2, "a2q")]


def _register(svc, n_slots=48, **kw):
    svc.register("d_arb", "a2q . c2a*", engine="dense", n_slots=n_slots, **kw)
    svc.register("d_plus", "(a2q | c2a)+", engine="dense", n_slots=n_slots, **kw)
    svc.register("d_smp", "(a2q | c2a | c2q)*", engine="dense",
                 path_semantics="simple", n_slots=n_slots, **kw)
    # (no reference RSPQ: the paper's RSPQ has no Delete algorithm)
    svc.register("r_arb", "a2q . c2a*", engine="reference")
    return svc


def _make_service(n_slots=48, **kwargs):
    return _register(PersistentQueryService(window=WINDOW, slide=SLIDE,
                                            device="cpu", **kwargs), n_slots)


def _make_jax(**kwargs):
    return _register(JaxService(window=WINDOW, slide=SLIDE, **kwargs))


def _stream_tuples():
    return list(with_deletions(so_like(24, 110, seed=13), ratio=0.04, seed=7))


def _jax_stream(tuples):
    return JaxStream([JaxSGT(s.ts, s.src, s.dst, s.label, s.op) for s in tuples])


def _step_dir(d):
    return jax_ckpt.latest_step_dir(d)


# -- the two packages on the same state -------------------------------------


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def both(request, tmp_path_factory):
    """Both packages' services fed the same first half and snapshotted
    (into their own directories), then fed the tail uninterrupted."""
    layout = LAYOUTS[request.param]
    tuples = _stream_tuples()
    half = len(tuples) // 2
    js, ts = _make_jax(**layout), _make_service(**layout)
    js.ingest(_jax_stream(tuples[:half]))
    ts.ingest(Stream(tuples[:half]))
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("port"))
    js.snapshot(jdir, step=half, wal_lsn=7, extra_meta={"churn": []})
    ts.snapshot(tdir, step=half, wal_lsn=7, extra_meta={"churn": []})
    jtail = js.ingest(_jax_stream(tuples[half:]))
    ttail = ts.ingest(Stream(tuples[half:]))
    return dict(layout=layout, tuples=tuples, half=half, jdir=jdir, tdir=tdir,
                jtail=jtail, ttail=ttail,
                final={n: js.results(n) for n in QUERY_NAMES})


def test_snapshot_files_agree_across_packages(both):
    jstep, tstep = _step_dir(both["jdir"]), _step_dir(both["tdir"])
    assert os.path.basename(jstep) == os.path.basename(tstep)
    with open(os.path.join(jstep, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tstep, "manifest.json")) as f:
        tm = json.load(f)
    # a pickle names its package's classes, so only its length differs
    for m in (jm, tm):
        m["arrays"]["refeng.r_arb"].pop("shape")
    assert tm == jm
    with np.load(os.path.join(jstep, "shard_00000.npz")) as zj, \
            np.load(os.path.join(tstep, "shard_00000.npz")) as zt:
        assert zt.files == zj.files
        for key in zj.files:
            if key.startswith("refeng."):
                continue
            assert zt[key].dtype == zj[key].dtype, key
            assert zt[key].shape == zj[key].shape, key
            np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)
        ej, et = (ckpt.unpickle_leaf(z["refeng.r_arb"]) for z in (zj, zt))
    assert type(ej) is type(et)
    assert et.results == ej.results
    assert sorted(vars(et)) == sorted(vars(ej))


def _assert_tail_equal(got, want):
    for name in QUERY_NAMES:
        assert got[name] == want[name], name
        assert got.invalidated[name] == want.invalidated[name], name


def test_jax_checkpoint_restores_in_port(both):
    svc = _make_service(**both["layout"])
    assert svc.restore(both["jdir"]) == both["half"]
    tail = svc.ingest(Stream(both["tuples"][both["half"]:]))
    _assert_tail_equal(tail, both["jtail"])
    _assert_tail_equal(tail, both["ttail"])
    for name in QUERY_NAMES:
        assert svc.results(name) == both["final"][name], name


def test_port_checkpoint_restores_in_jax(both):
    js = _make_jax(**both["layout"])
    assert js.restore(both["tdir"]) == both["half"]
    tail = js.ingest(_jax_stream(both["tuples"][both["half"]:]))
    _assert_tail_equal(tail, both["jtail"])
    for name in QUERY_NAMES:
        assert js.results(name) == both["final"][name], name


# -- a lane that fell back to the host RSPQ ---------------------------------


def _fallback_registrations(svc, simple_engine="dense"):
    svc.register("q3", "a2q . c2a* . c2q*", engine="dense", n_slots=48)
    svc.register("q3s", "a2q . c2a* . c2q*", engine=simple_engine,
                 path_semantics="simple", n_slots=48)
    svc.register("r", "(a2q | c2a)+", engine="reference")
    return svc


def _fallback_stream():
    tuples = [s for s in so_like(24, 110, seed=13)]
    head, tail = tuples[:40], tuples[40:80]
    t0 = head[-1].ts
    extra = [SGT(t0 + 0.01 * (i + 1), u, v, lab)
             for i, (u, v, lab) in enumerate(CONFLICT)]
    return head + extra, tail


@pytest.fixture(scope="module")
def fallback_ckpt(tmp_path_factory):
    """A JAX and a port service whose simple lane q3s fell back, snapshotted,
    and their results over the tail afterwards."""
    head, tail = _fallback_stream()
    js = _fallback_registrations(JaxService(window=WINDOW, slide=SLIDE))
    ts = _fallback_registrations(PersistentQueryService(
        window=WINDOW, slide=SLIDE, device="cpu"))
    rj, rt = js.ingest(_jax_stream(head)), ts.ingest(Stream(head))
    assert rj.fallbacks == rt.fallbacks == {"q3s": "conflict -> reference RSPQ"}
    jdir = str(tmp_path_factory.mktemp("jax_fb"))
    tdir = str(tmp_path_factory.mktemp("port_fb"))
    js.snapshot(jdir, step=1)
    ts.snapshot(tdir, step=1)
    fb_leaf = jax_ckpt.pickle_leaf(js._ref_engines["q3s"])
    fb_results = set(js._ref_engines["q3s"].results)
    jtail = js.ingest(_jax_stream(tail))
    ttail = ts.ingest(Stream(tail))
    assert dict(jtail) == dict(ttail)
    return dict(jdir=jdir, tdir=tdir, tail=tail, jtail=jtail, fb_leaf=fb_leaf,
                fb_results=fb_results,
                final={n: js.results(n) for n in ("q3", "q3s", "r")})


def test_unpickle_jax_rspq_fallback(fallback_ckpt):
    from repro.streaming.service import RSPQFallback as JaxFallback

    fb = ckpt.unpickle_leaf(fallback_ckpt["fb_leaf"])
    jfb = __import__("pickle").loads(fallback_ckpt["fb_leaf"].tobytes())
    assert type(fb) is RSPQFallback and type(jfb) is JaxFallback
    assert sorted(vars(fb)) == sorted(vars(jfb))
    assert (fb.window, fb._edges, fb._emitted) == \
        (jfb.window, jfb._edges, jfb._emitted)
    assert fb.results == jfb.results == fallback_ckpt["fb_results"]
    assert (fb.dfa.labels, fb.dfa.start, fb.dfa.finals) == \
        (jfb.dfa.labels, jfb.dfa.start, jfb.dfa.finals)
    np.testing.assert_array_equal(fb.dfa.delta, jfb.dfa.delta)
    assert type(fb._rspq).__module__ == "repro_torch.core.reference"
    for s in fallback_ckpt["tail"]:
        if s.ts >= 40.0:
            break
        assert fb.insert(s.src, s.dst, s.label, s.ts) == \
            jfb.insert(s.src, s.dst, s.label, s.ts)
    assert fb.results == jfb.results


def test_port_restore_of_jax_checkpoint_imports_neither_jax_nor_repro(
        fallback_ckpt, tmp_path):
    script = tmp_path / "restore.py"
    script.write_text(
        "import json, sys\n"
        "from repro_torch.streaming.generators import so_like\n"
        "from repro_torch.streaming.service import PersistentQueryService, RSPQFallback\n"
        "from repro_torch.streaming.stream import Stream\n"
        "svc = PersistentQueryService(window=20.0, slide=2.0, device='cpu')\n"
        "svc.register('q3', 'a2q . c2a* . c2q*', engine='dense', n_slots=48)\n"
        "svc.register('q3s', 'a2q . c2a* . c2q*', engine='reference',\n"
        "             path_semantics='simple')\n"
        "svc.register('r', '(a2q | c2a)+', engine='reference')\n"
        f"step = svc.restore({fallback_ckpt['jdir']!r})\n"
        "assert type(svc._ref_engines['q3s']) is RSPQFallback\n"
        "tail = list(so_like(24, 110, seed=13))[40:80]\n"
        "rep = svc.ingest(Stream(tail))\n"
        "print(json.dumps({'step': step,\n"
        "    'new': {k: sorted(map(list, v)) for k, v in rep.items()},\n"
        "    'final': {k: sorted(map(list, svc.results(k))) for k in ('q3', 'q3s', 'r')},\n"
        "    'leaked': sorted(m for m in sys.modules\n"
        "                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))}))\n")
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, check=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert got["step"] == 1
    jtail = fallback_ckpt["jtail"]
    assert got["new"] == {k: sorted(map(list, v)) for k, v in jtail.items()}
    assert got["final"] == {k: sorted(map(list, v))
                            for k, v in fallback_ckpt["final"].items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_after_fallback_into_dense_lane_raises_in_both(fallback_ckpt,
                                                               writer):
    """The JAX package's contract, kept: the checkpoint records q3s as a
    reference engine, a fresh service registers it as a dense simple lane,
    and the live query sets differ."""
    d = fallback_ckpt["jdir" if writer == "jax" else "tdir"]
    msg = r"checkpointed query set \['q3'\] does not match registered set " \
          r"\['q3', 'q3s'\]"
    js = _fallback_registrations(JaxService(window=WINDOW, slide=SLIDE))
    with pytest.raises(ValueError, match=msg):
        js.restore(d)
    ts = _fallback_registrations(PersistentQueryService(
        window=WINDOW, slide=SLIDE, device="cpu"))
    with pytest.raises(ValueError, match=msg):
        ts.restore(d)


# -- ckpt itself ---------------------------------------------------------------


def test_flatten_keys_and_order_match_jax(tmp_path):
    NT = collections.namedtuple("NT", "b a")
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal((3,)).astype(np.float32) for _ in range(6)]
    port_tree = {"z": [torch.from_numpy(vals[0]), None,
                       (torch.from_numpy(vals[1]), vals[2])],
                 "a": NT(vals[3], np.int32(5)), "m": {"y": vals[4], "b": vals[5]}}
    jax_tree = {"z": [jnp.asarray(vals[0]), None, (jnp.asarray(vals[1]), vals[2])],
                "a": NT(vals[3], np.int32(5)), "m": {"y": vals[4], "b": vals[5]}}
    assert list(ckpt._flatten(port_tree)) == list(jax_ckpt._flatten(jax_tree))
    ckpt.save(str(tmp_path / "p"), 3, port_tree, extra={"k": 1})
    jax_ckpt.save(str(tmp_path / "j"), 3, jax_tree, extra={"k": 1})
    mp, mj = (json.load(open(tmp_path / d / "step_000000003" / "manifest.json"))
              for d in ("p", "j"))
    assert mp == mj
    back, extra = ckpt.restore(str(tmp_path / "j"), like=port_tree)
    assert extra == {"k": 1} and back["z"][1] is None
    assert isinstance(back["z"][0], torch.Tensor) and isinstance(back["z"][2][1], np.ndarray)
    assert type(back["a"]) is NT and back["a"].a == 5
    torch.testing.assert_close(back["z"][2][0], torch.from_numpy(vals[1]), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_bit_view_dtypes_cross_packages(tmp_path, dtype):
    x = torch.linspace(-3.0, 3.0, 17).to(getattr(torch, dtype))
    ckpt.save(str(tmp_path / "p"), 1, {"w": x})
    back, _ = jax_ckpt.restore(str(tmp_path / "p"), like={"w": jnp.zeros((1,), dtype)})
    np.testing.assert_array_equal(
        np.asarray(back["w"]).astype(np.float32), x.float().numpy())
    jax_ckpt.save(str(tmp_path / "j"), 1, {"w": back["w"]})
    for d in ("p", "j"):
        got, _ = ckpt.restore(str(tmp_path / d), like={"w": torch.zeros(1, dtype=x.dtype)})
        assert got["w"].dtype == x.dtype
        assert torch.equal(got["w"].view(torch.uint8), x.view(torch.uint8))


def test_async_save_copies_on_the_callers_thread(tmp_path):
    state = {"x": torch.zeros(4096), "n": np.zeros(3, np.int32)}
    ckpt.async_save(str(tmp_path), 1, state, extra={"step": 1})
    state["x"].add_(1.0)   # the next dispatch mutates state in place
    state["n"] += 7
    ckpt.wait_pending(str(tmp_path))
    back, extra = ckpt.restore(str(tmp_path), like=state)
    assert extra == {"step": 1}
    assert torch.equal(back["x"], torch.zeros(4096))
    assert back["n"].tolist() == [0, 0, 0]


def test_unpickler_refuses_other_repro_classes():
    from repro.core.regex import parse

    leaf = jax_ckpt.pickle_leaf(parse("a . b"))
    with pytest.raises(Exception, match="no counterpart in repro_torch"):
        ckpt.unpickle_leaf(leaf)


# -- tests/test_fault.py, on the port -------------------------------------------


def test_crash_restore_identical_result_stream():
    tuples = _stream_tuples()
    half = len(tuples) // 2
    svc = _make_service()
    svc.ingest(Stream(tuples[:half]))
    next_expiry_at_ckpt = svc._next_expiry
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.snapshot(ckpt_dir, step=half)
        mid_results = {name: svc.results(name) for name in QUERY_NAMES}
        tail_new = svc.ingest(Stream(tuples[half:]))
        final_results = {name: svc.results(name) for name in QUERY_NAMES}

        svc2 = _make_service()
        assert svc2.restore(ckpt_dir) == half
        for name in QUERY_NAMES:
            assert svc2.results(name) == mid_results[name], name
        assert svc2._next_expiry == next_expiry_at_ckpt
        tail_new2 = svc2.ingest(Stream(tuples[half:]))
        for name in QUERY_NAMES:
            assert tail_new2[name] == tail_new[name], name
            assert svc2.results(name) == final_results[name], name
            assert svc2.stats[name].conflicted == svc.stats[name].conflicted


def test_restore_rejects_mismatched_query_set():
    svc = _make_service()
    svc.ingest(Stream(_stream_tuples()[:40]))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.snapshot(ckpt_dir, step=1)
        svc2 = PersistentQueryService(window=WINDOW, slide=SLIDE, device="cpu")
        svc2.register("other", "a2q*", engine="dense", n_slots=48)
        with pytest.raises((ValueError, KeyError)):
            svc2.restore(ckpt_dir)


def test_register_after_ingest_is_live():
    svc = _make_service()
    svc.ingest(Stream(_stream_tuples()[:20]))
    before = {name: svc.results(name) for name in QUERY_NAMES}
    initial = svc.register("late", "a2q*", engine="dense")
    group = svc.queries["late"]
    assert initial == group.current_results(group.lane_of("late"))
    assert svc.results("late") == initial
    for name in QUERY_NAMES:
        assert svc.results(name) == before[name], name


def test_checkpoint_restore_with_churned_group():
    """A group that grew by a live registration (bucketed-Q padding)
    restores into a fresh service that registered the same final query set
    up front (another lane layout), matched by name."""
    tuples = _stream_tuples()
    half = len(tuples) // 2
    svc = _make_service()
    svc.ingest(Stream(tuples[:half]))
    svc.register("late", "a2q . c2q*", engine="dense")
    names = QUERY_NAMES + ["late"]
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.snapshot(ckpt_dir, step=half)
        tail_new = svc.ingest(Stream(tuples[half:]))
        final = {name: svc.results(name) for name in names}

        svc2 = _make_service()
        svc2.register("late", "a2q . c2q*", engine="dense", n_slots=48)
        assert svc2.restore(ckpt_dir) == half
        tail_new2 = svc2.ingest(Stream(tuples[half:]))
        for name in names:
            assert tail_new2[name] == tail_new[name], name
            assert svc2.results(name) == final[name], name


def test_crash_between_async_save_and_wait_pending_falls_back():
    """A kill at each stage of the commit protocol never surfaces a
    partial checkpoint: restore lands on the previously published step."""
    tuples = _stream_tuples()
    svc = _make_service()
    svc.ingest(Stream(tuples[:40]))
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d, step=1)
        committed = ckpt.latest_step_dir(d)
        assert committed is not None and committed.endswith("step_000000001")
        mid_results = {name: svc.results(name) for name in QUERY_NAMES}
        tail_new = svc.ingest(Stream(tuples[40:]))

        for step, stage in ((2, "shards"), (3, "manifest")):
            svc.snapshot(d, step=step, async_save=True, _crash_after=stage)
            ckpt.wait_pending(d)
            assert any(".tmp" in n for n in os.listdir(d)), stage
            assert ckpt.latest_step_dir(d) == committed, stage

        svc2 = _make_service()
        assert svc2.restore(d) == 1
        for name in QUERY_NAMES:
            assert svc2.results(name) == mid_results[name], name
        tail_new2 = svc2.ingest(Stream(tuples[40:]))
        for name in QUERY_NAMES:
            assert tail_new2[name] == tail_new[name], name
            assert svc2.results(name) == svc.results(name), name

        svc.snapshot(d, step=4, async_save=True, _crash_after="rename")
        ckpt.wait_pending(d)
        assert os.path.isdir(os.path.join(d, "step_000000004"))
        assert ckpt.latest_step_dir(d) == committed
        svc3 = _make_service()
        assert svc3.restore(d) == 1
        for name in QUERY_NAMES:
            assert svc3.results(name) == mid_results[name], name


def test_snapshot_drains_pending_async_decode_fifo():
    """A snapshot with a dispatch still undecoded drains it first: state
    and results agree, nothing is dropped or emitted twice."""
    tuples = _stream_tuples()
    svc = _make_service(async_decode=True, async_depth=4)
    svc.ingest(Stream(tuples[:60]))
    group = svc.queries["d_arb"]
    pending_batch = [(s.src, s.dst, s.label, s.ts)
                     for s in tuples[60:] if s.op == "+"][:8]
    handle = group.insert_batch_pending(pending_batch)
    assert len(group._pending_fifo) == 1

    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d, step=1)
        assert len(group._pending_fifo) == 0
        after_snapshot = {name: svc.results(name) for name in QUERY_NAMES}
        handle.resolve()
        assert {name: svc.results(name) for name in QUERY_NAMES} == after_snapshot

        svc2 = _make_service(async_decode=True, async_depth=4)
        assert svc2.restore(d) == 1
        for name in QUERY_NAMES:
            assert svc2.results(name) == after_snapshot[name], name
        rest = [s for s in tuples[60:]
                if (s.src, s.dst, s.label, s.ts) not in pending_batch]
        tail_new = svc.ingest(Stream(rest))
        tail_new2 = svc2.ingest(Stream(rest))
        for name in QUERY_NAMES:
            assert tail_new2[name] == tail_new[name], name
            assert svc2.results(name) == svc.results(name), name


# -- tests/test_query_churn.py:364 and tests/test_engine_regressions.py:93-136 --


def test_service_checkpoint_records_live_query_set():
    svc = PersistentQueryService(window=50.0, slide=10.0, device="cpu")
    svc.register("q0", "a*", engine="dense", n_slots=16)
    svc.ingest(Stream([SGT(1.0, 0, 1, "a")]))
    svc.register("q1", "a . b*", engine="dense")   # grows Q to a bucket of 4
    svc.deregister("q0")
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d, step=3)
        extra = ckpt.manifest_extra(d)
        lanes = extra["dense"]["order"]
        assert lanes[1] == "q1" and lanes[0] is None
        assert extra["dense"]["labels"] == ["a", "b"]
        svc2 = PersistentQueryService(window=50.0, slide=10.0, device="cpu")
        svc2.register("q1", "a . b*", engine="dense", n_slots=16)
        assert svc2.restore(d) == 3
        assert svc2.results("q1") == svc.results("q1")


def _single(n_slots=8):
    return DenseRPQEngine(compile_query("a"), window=100.0, n_slots=n_slots,
                          batch_size=1, device="cpu")


def test_interner_state_preserves_vertex_types():
    eng = _single()
    eng.insert("42", 42, "a", 1.0)
    eng.insert(("p", 7), "x", "a", 2.0)
    state = json.loads(json.dumps(eng.interner_state()))  # manifest trip
    eng2 = _single()
    eng2.load_interner(state)
    assert eng2.slot_of == eng.slot_of
    assert set(eng2.slot_of) == {"42", 42, ("p", 7), "x"}
    assert eng2.vertex_of == eng.vertex_of
    assert sorted(eng2.free) == sorted(eng.free)


def test_legacy_untyped_interner_still_loads():
    eng = _single()
    eng.load_interner({"7": 0, "name": 1})
    assert eng.slot_of == {7: 0, "name": 1}
    eng.load_interner({"format": 2, "entries": 3})
    assert eng.slot_of == {"format": 2, "entries": 3}


def test_results_state_roundtrip_tuple_and_numeric_string_vertices():
    eng = _single()
    eng.insert("42", ("p", 7), "a", 1.0)
    eng.insert(42, "42", "a", 2.0)
    assert eng.results == {("42", ("p", 7)), (42, "42")}
    state = json.loads(json.dumps(eng.results_state()))
    eng2 = _single()
    eng2.load_results_state(state)
    assert eng2.results == eng.results


# -- the bucket backend and other capacities -----------------------------------


def _snapshot_tail_restore(writer, reader, names, mutate=None):
    """Snapshot ``writer`` after the first half (and ``mutate(writer)``),
    feed it the tail, restore ``reader`` and feed it the tail: the tails
    and finals must agree."""
    tuples = _stream_tuples()
    half = len(tuples) // 2
    writer.ingest(Stream(tuples[:half]))
    if mutate is not None:
        mutate(writer)
    with tempfile.TemporaryDirectory() as d:
        writer.snapshot(d, step=half)
        tail = writer.ingest(Stream(tuples[half:]))
        assert reader.restore(d) == half
    tail2 = reader.ingest(Stream(tuples[half:]))
    for name in names:
        assert tail2[name] == tail[name], name
        assert tail2.invalidated[name] == tail.invalidated[name], name
        assert reader.results(name) == writer.results(name), name
    return reader


def test_bucket_backend_snapshot_restore():
    def make():
        svc = PersistentQueryService(window=WINDOW, slide=SLIDE, device="cpu")
        svc.register("d_arb", "a2q . c2a*", n_slots=48, backend="mxu_bucket")
        svc.register("d_plus", "(a2q | c2a)+", n_slots=48, backend="mxu_bucket")
        return svc

    _snapshot_tail_restore(make(), make(), ["d_arb", "d_plus"])


def test_restore_grows_to_a_larger_slot_capacity():
    reader = _snapshot_tail_restore(_make_service(n_slots=96),
                                    _make_service(n_slots=48), QUERY_NAMES)
    assert reader.queries["d_arb"].n_slots == 96


def test_restore_across_lane_padding():
    """The writer's lanes have holes (deregistered mid-stream) and a larger
    Q; the reader registers the live set alone, in another order."""
    writer = _make_service()
    for i in range(3):
        writer.register(f"extra{i}", "c2q . a2q*", n_slots=48)

    def mutate(svc):
        svc.deregister("extra1")
        svc.deregister("d_plus")

    reader = PersistentQueryService(window=WINDOW, slide=SLIDE, device="cpu")
    reader.register("extra2", "c2q . a2q*", n_slots=48)
    reader.register("d_arb", "a2q . c2a*", n_slots=48)
    reader.register("extra0", "c2q . a2q*", n_slots=48)
    reader.register("d_smp", "(a2q | c2a | c2q)*", path_semantics="simple",
                    n_slots=48)
    reader.register("r_arb", "a2q . c2a*", engine="reference")
    names = ["d_arb", "d_smp", "r_arb", "extra0", "extra2"]
    reader = _snapshot_tail_restore(writer, reader, names, mutate)
    assert writer.queries["d_arb"].q_cap == 6
    assert reader.queries["d_arb"].q_cap == 4
