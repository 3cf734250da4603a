#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--edges E]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: the card's name, count, and ``nvidia-smi`` name and power
   limit. Fails without CUDA, and when run outside a checkout of the repo.
2. build: kernel B1 (``src/repro_torch/csrc/maxmin.cu``) with nvcc for
   sm_90a; prints the build seconds and ptxas' registers, shared memory
   and spills.
3. kernel: B1 against its plain PyTorch version on the card with
   ``torch.equal`` (tolerance 0: max and min never reassociate) on the
   test shapes in float32 and float16 and on the main path's shape; then
   CUDA-event times at the main path's (J, N) and at N=4096, beside the
   bound (the larger of bytes over 3.35 TB/s and min/max operations over
   67 TFLOP/s, the H100 SXM's published rates).
4. end to end: ``PersistentQueryService(window=20, slide=2)`` with the 11
   Table-2 queries over the SO labels as one dense group at n_slots=2048,
   each also registered as a reference RAPQ engine, plus simple-path lanes
   of Q2 and Q3, fed E insert sgts of an SO-like stream with 2% deletions
   and, 40 inserts before the end, three edges that give Q3 a conflict.
   Asserts every arbitrary-semantics dense query's results equal its
   reference engine's, that the conflict probe moved Q3's simple lane to
   the reference RSPQ and its results equal a host RSPQ fed the whole
   stream, that Q2's conflict-free simple lane equals Q2, and that B1
   was launched once per closure round of the run.
5. trace: a further short window of the same stream under
   ``torch.profiler``: its top device kernels by time.

The last three lines of standard output are the kernels JSON line, the
``nvidia-smi`` name/power-limit line, and the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# paper Table 2 over the SO labels (benchmarks/common.py: a->a2q, b->c2a,
# c->c2q)
TABLE2 = {
    "Q1": "a*", "Q2": "a . b*", "Q3": "a . b* . c*", "Q4": "(a | b | c)*",
    "Q5": "a . b* . c", "Q6": "a* . b*", "Q7": "a . b . c*", "Q8": "a? . b*",
    "Q9": "(a | b | c)+", "Q10": "(a | b | c) . b*", "Q11": "a . b . c",
}
SO_LABEL = {"a": "a2q", "b": "c2a", "c": "c2q"}

# tests/test_kernels.py: SHAPES (m, k, n) run as J=1, ODD_SHAPES (J, m, k, n)
SHAPES = [(8, 8, 8), (128, 128, 128), (130, 70, 200), (1, 256, 33),
          (257, 1, 129), (64, 512, 64)]
ODD_SHAPES = [(3, 4, 40, 40), (5, 16, 33, 33), (2, 1, 7, 19), (7, 23, 5, 64),
              (1, 130, 70, 30)]

PROFILE_SGTS = 24         # sgts of the traced window after the main run
CONFLICT_BEFORE_END = 40  # inserts of the main run after the Q3 conflict
PEAK_F32_OPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def so_queries():
    return {name: re.sub(r"[abc]", lambda m: SO_LABEL[m.group(0)], expr)
            for name, expr in TABLE2.items()}


def with_q3_conflict(SGT, tuples, before_end: int):
    """``tuples`` plus three edges that give Q3 (a2q . c2a* . c2q*) a
    conflict, placed ``before_end`` inserts before the end: x reaches z in
    the state after a2q (suffix language c2a* . c2q*) and in the state
    after a2q . c2q (suffix language c2q*), which does not contain it.
    x, y, z are vertex ids of the SO-like stream's own range."""
    inserts = [i for i, s in enumerate(tuples) if s.op == "+"]
    i = inserts[-before_end]
    t0, t1 = tuples[i - 1].ts, tuples[i].ts
    step = (t1 - t0) / 4
    x, y, z = 0, 1, 2
    extra = [SGT(t0 + step, x, y, "a2q"), SGT(t0 + 2 * step, y, z, "c2q"),
             SGT(t0 + 3 * step, x, z, "a2q")]
    return tuples[:i] + extra + tuples[i:]


def host_simple_results(fallback_cls, compile_query, expr, window, slide,
                        tuples):
    """Result pairs of a host RSPQ (with rebuild-on-delete) fed ``tuples``
    from the start, expiring at the service's slide boundaries."""
    eng = fallback_cls(compile_query(expr), window)
    nxt = slide
    for s in tuples:
        if s.ts >= nxt:
            eng.expire(s.ts)
            while nxt <= s.ts:
                nxt += slide
        if s.op == "+":
            eng.insert(s.src, s.dst, s.label, s.ts)
        else:
            eng.delete(s.src, s.dst, s.label, s.ts)
    return eng.results


def bound_ms(j: int, m: int, k: int, n: int, itemsize: int = 4):
    """(bound in ms, "bytes" | "operations") of one (J,m,k)x(J,k,n) max-min
    product: each input read once and the output written once, against
    one min and one max per (j, i, k, n)."""
    t_bytes = itemsize * (j * m * k + j * k * n + j * m * n) / PEAK_BYTES
    t_ops = 2.0 * j * m * k * n / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_cuda(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--edges", type=int, default=1024,
                    help="insert sgts of the end-to-end stream (>= 256)")
    args = ap.parse_args()
    if args.edges < 256:
        fail("--edges must be at least 256")
    if not (ROOT / "src" / "repro_torch" / "csrc" / "maxmin.cu").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    # -- 1. device -----------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA card")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    smi_line = smi[0].strip()
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi_line}", flush=True)

    from repro_torch.core.automaton import compile_query
    from repro_torch.kernels import build
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService, RSPQFallback
    from repro_torch.streaming.stream import SGT, Stream

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.load("maxmin")
    info = build.BUILD_INFO["maxmin"]
    print(f"[build] maxmin.cu: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {info['seconds']:.3f} s) -> {info['path']}", flush=True)
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}", flush=True)

    # -- 3. kernel against its plain version -----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand_ts(shape, dtype, density=0.7):
        x = torch.rand(shape, generator=gen, device="cuda") * 1000.0
        x[torch.rand(shape, generator=gen, device="cuda") > density] = float("-inf")
        return x.to(dtype)

    max_err = 0.0

    def check(j, m, k, n, dtype):
        nonlocal max_err
        a, b = rand_ts((j, m, k), dtype), rand_ts((j, k, n), dtype)
        a[:, : max(1, m // 7)] = float("-inf")        # all -inf rows
        out = b1.maxmin_matmul_fused(a, b)
        torch.cuda.synchronize()
        ref = maxmin_matmul_fused_ref(a, b)
        same = out == ref
        err = (out.float() - ref.float()).abs().masked_fill(same, 0.0)
        err = float(err.max()) if err.numel() else 0.0
        max_err = max(max_err, err)
        if not torch.equal(out, ref):
            fail(f"B1 differs from its plain version at J={j} m={m} k={k} "
                 f"n={n} {dtype}: max |err| {err}")

    n_checks = 0
    for dtype in (torch.float32, torch.float16):
        for (m, k, n) in SHAPES:
            check(1, m, k, n, dtype)
            n_checks += 1
        for (j, m, k, n) in ODD_SHAPES:
            check(j, m, k, n, dtype)
            n_checks += 1
    print(f"[kernel] B1 == plain (torch.equal) on {n_checks} test shapes, "
          "float32 and float16", flush=True)

    # the service's dense group fixes the main path's shapes (J rows, N slots)
    window, slide, n_slots = 20.0, 2.0, 2048
    svc = PersistentQueryService(window=window, slide=slide)
    queries = so_queries()
    for name, expr in queries.items():
        svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
        svc.register(f"{name}_ref", expr, engine="reference")
    # simple-path lanes: Q2's DFA can never reach one vertex in two states,
    # so its conflict probe runs but never fires; Q3's can, and the edges
    # added by with_q3_conflict move it to the reference RSPQ (the fallback)
    for name in ("Q2", "Q3"):
        svc.register(f"{name}_simple", queries[name], engine="dense",
                     path_semantics="simple", n_slots=n_slots, batch_size=1)
    group = svc.queries["Q1"]
    J, N, K, Q = (group.btt.qidx.shape[0], group.n_slots, group.k, group.q_cap)
    print(f"[path] dense group: {Q} lanes, J={J} transition rows, K={K}, "
          f"N={N} slots, {len(group.labels)} labels", flush=True)

    check(J, N, N, N, torch.float32)
    print(f"[kernel] B1 == plain (torch.equal) at the main path's shape "
          f"J={J} m=k=n={N} float32; max |err| over all checks {max_err}",
          flush=True)

    timings = {}
    for n_t, reps in ((N, 5), (2 * N, 2)):
        a = rand_ts((J, n_t, n_t), torch.float32)
        b = rand_ts((J, n_t, n_t), torch.float32)
        ms = time_cuda(torch, lambda: b1.maxmin_matmul_fused(a, b), reps)
        bms, by = bound_ms(J, n_t, n_t, n_t)
        plain = None
        if n_t == N:
            plain = time_cuda(torch, lambda: maxmin_matmul_fused_ref(a, b), 1)
        timings[n_t] = (ms, bms, by, plain)
        print(f"[kernel] B1 J={J} N={n_t}: {ms:.3f} ms, bound {bms:.3f} ms "
              f"({by}), {100 * bms / ms:.1f}% of bound; plain "
              f"{'%.3f ms' % plain if plain is not None else 'not measured'}",
              flush=True)
        del a, b
    torch.cuda.empty_cache()

    # -- 4. end to end ---------------------------------------------------------
    # E inserts for the main run, then PROFILE_SGTS more for a traced window
    stream = with_deletions(so_like(n_vertices=n_slots,
                                    n_edges=args.edges + PROFILE_SGTS, seed=42),
                            ratio=0.02, seed=1)
    all_tuples = list(stream)
    cut = [i for i, s in enumerate(all_tuples) if s.op == "+"][args.edges]
    tuples = with_q3_conflict(SGT, all_tuples[:cut], CONFLICT_BEFORE_END)
    tail = all_tuples[cut:]
    n_del = sum(1 for s in tuples if s.op == "-")
    print(f"[e2e] E={args.edges} insert sgts + 3 that give Q3 a conflict + "
          f"{n_del} deletions = {len(tuples)} sgts over {tuples[-1].ts:.1f} s "
          "of stream time", flush=True)
    ex = group.executor
    rounds0, steps0, syncs0 = ex.rounds_total, ex.steps, group.host_syncs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b1.maxmin_matmul_fused.launches = 0
    t0 = time.perf_counter()
    report = svc.ingest(Stream(tuples), record_latency=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b1.maxmin_matmul_fused.launches
    rounds = ex.rounds_total - rounds0
    steps = ex.steps - steps0
    syncs = group.host_syncs - syncs0
    peak = torch.cuda.max_memory_allocated()

    if launches <= 0:
        fail("kernel B1 was never launched on the main path")
    if launches != rounds:
        fail(f"B1 launches ({launches}) != closure rounds run ({rounds})")
    mismatched = [name for name in queries
                  if svc.results(name) != svc.results(f"{name}_ref")]
    if mismatched:
        fail(f"dense results differ from the reference RAPQ for {mismatched}")
    n_results = {name: len(svc.results(name)) for name in queries}
    if sum(n_results.values()) == 0:
        fail("no query produced any result: the stream exercised nothing")
    # simple-path lanes: Q2 is conflict-free, so its simple lane is Q2 less
    # the (x, x) pairs; Q3's conflict moved its lane to the host RSPQ, whose
    # results lie between an exact RSPQ fed the whole stream and Q3's
    # arbitrary-semantics results (the dispatch that showed the conflict
    # emitted before the switch)
    if report.fallbacks != {"Q3_simple": "conflict -> reference RSPQ"}:
        fail(f"expected exactly Q3's simple lane to fall back, got "
             f"{report.fallbacks}")
    if svc.results("Q2_simple") != {p for p in svc.results("Q2") if p[0] != p[1]}:
        fail("Q2's simple lane differs from Q2 without its (x, x) pairs")
    exact = host_simple_results(RSPQFallback, compile_query, queries["Q3"],
                                window, slide, tuples)
    q3_simple = svc.results("Q3_simple")
    if not exact <= q3_simple <= svc.results("Q3"):
        fail("Q3's simple results are not between the host RSPQ's and Q3's")
    lat = sorted(svc.stats["Q1"].latencies_us)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
    ms_b1 = timings[N][0]
    # host clock per path (record_latency): every dense query records the
    # group's dispatch time, so one of them carries it
    dense_s = sum(svc.stats["Q1"].latencies_us) / 1e6
    ref_s = sum(sum(svc.stats[f"{name}_ref"].latencies_us)
                for name in queries) / 1e6
    print(f"[e2e] {len(tuples)} sgts in {wall:.3f} s = "
          f"{len(tuples) / wall:.3f} sgts/s; dispatch p50 {p50 / 1e3:.3f} ms, "
          f"p99 {p99 / 1e3:.3f} ms", flush=True)
    print(f"[e2e] {steps} dispatches, {rounds} closure rounds "
          f"({rounds / steps:.3f} per dispatch), host syncs "
          f"{syncs / steps:.3f} per dispatch, B1 launches {launches} "
          f"({launches / len(tuples):.3f} per sgt); B1 at {ms_b1:.3f} ms "
          f"x {launches} = {launches * ms_b1 / 1e3:.3f} s of {wall:.3f} s wall",
          flush=True)
    print(f"[e2e] wall split (host clock): dense-group dispatches "
          f"{dense_s:.3f} s, 11 reference RAPQ engines {ref_s:.3f} s, rest "
          f"{wall - dense_s - ref_s:.3f} s", flush=True)
    print(f"[e2e] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    print(f"[e2e] results per query: {n_results}; deletions "
          f"{report.deletions}; fallbacks {report.fallbacks}; dense results "
          "== reference RAPQ for all 11 queries", flush=True)
    print(f"[e2e] Q3 simple: {len(q3_simple)} pairs after the fallback, "
          f"host RSPQ {len(exact)}, Q3 {n_results['Q3']}; J={J} before the "
          f"fallback, {group.btt.qidx.shape[0]} after", flush=True)

    # -- 5. a traced window of the same path -----------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: recording every CPU-side op of the host loop
    # tripled the window's wall time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        svc.ingest(Stream(tail), record_latency=True)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    print(f"[trace] top device kernels over {len(tail)} traced sgts"
          f"{'' if by_name else ': the profiler recorded no device time'}",
          flush=True)
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[trace]   {us / 1e3:10.3f} ms  {key[:90]}", flush=True)

    ms, bms, by, plain = timings[N]
    print(json.dumps({"kernels": [{
        "name": "B1 maxmin_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/maxmin.cu",
        "replaces": "src/repro/kernels/maxmin/maxmin.py:138",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
    }]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
