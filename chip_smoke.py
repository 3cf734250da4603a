#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--edges E] [--ell-inserts I]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: the card's name, count, and ``nvidia-smi`` name and power
   limit. Fails without CUDA, and when run outside a checkout of the repo.
2. build: kernels B1 and B2 (``src/repro_torch/csrc/maxmin.cu``), B5
   (``src/repro_torch/csrc/ell.cu``), B6 (``src/repro_torch/csrc/
   rowsparse.cu``) and B3 and B4 (``src/repro_torch/csrc/bucket.cu``) with
   nvcc for sm_90a, one nvcc each, started together; prints the build
   seconds and ptxas' registers, shared memory and spills.
3. kernel: B1, B5 and B6 against their plain PyTorch versions on the card
   with ``torch.equal`` (tolerance 0: max and min never reassociate) on
   the test shapes (B1 also in float16 and on block-sparse operands whose
   whole kernel tiles are -inf, which its occupancy pre-pass lets it skip),
   B1 at the dense path's shape and at the frontier's skinny (J=48, m in
   {4, 32}, 2048, 2048) slabs; the min/max instruction-rate microbenchmark
   (FFMA, FMNMX, the two-input integer min/max and the DPX
   ``__vimax3_s32``: lane operations per second, and per clock per SM at
   the SM clock ``nvidia-smi`` reads during the run; the SASS instruction
   counts);
   then CUDA-event times of B1 on uniform operands (density 0.7) in [0,
   1000) at the dense path's (J, N), at N=4096 and at m in {4, 32}, and in
   [-500, 500) at (J, N) (B1's float compare path), beside the bound (the
   larger of bytes over 3.35 TB/s and min/max operations over 67 TFLOP/s,
   the H100 SXM's published rates) and the time the kernel's own min/max
   instructions (1.5 per (i, k, n) on the integer path, 2 on the float
   path) take at the measured rate.
4. end to end: ``PersistentQueryService(window=20, slide=2)`` with the 11
   Table-2 queries over the SO labels as one dense group at n_slots=2048,
   each also registered as a reference RAPQ engine, plus simple-path lanes
   of Q2 and Q3, fed E insert sgts of an SO-like stream with 2% deletions
   and, 40 inserts before the end, three edges that give Q3 a conflict.
   Asserts every arbitrary-semantics dense query's results equal its
   reference engine's, that the conflict probe moved Q3's simple lane to
   the reference RSPQ and its results equal a host RSPQ fed the whole
   stream, that Q2's conflict-free simple lane equals Q2, and that B1
   was launched once per closure round of the run. Then B1 on the run's
   own last-round operands (the final dist gathered per transition row and
   the adjacency rows of their labels): ``torch.equal`` against the plain
   version, the share of operand tiles that hold an entry, and the
   CUDA-event time beside the bound counted from what those inputs need.
5. trace: a further short window of the same stream under
   ``torch.profiler``: its top device kernels by time.
6. end to end, frontier and ELL: ``PersistentQueryService(window=20,
   slide=2, frontier="auto", frontier_cap=4, adj_layout="ell", ell_cap=2)``
   with the 11 Table-2 queries as one dense group at n_slots=8192, each
   also a reference RAPQ engine, fed I insert sgts of
   ``so_like(n_vertices=8192, rate=50)`` (about 1000 live edges in a 20 s
   window) with 2% deletions, B=1. Asserts every query's results and
   per-event result log equal its reference engine's, that B5 was
   launched once per closure round
   and B1 never, that the frontier ran and also fell back (dispatches >
   fallbacks >= 1), that a delete went through the cone, and that the
   spill ring drained and re-packed.
7. B5 at the path's shapes: on this run's final operands (the gathered
   dist rows and the ELL rows of the transition labels), ``torch.equal``
   against the plain version at the frontier's (J, F, 8192, E) and the
   dense round's (J, 8192, 8192, E), and CUDA-event times beside the
   bound, the plain version and the two-call PyTorch yardstick
   (``torch.minimum`` of the broadcast candidates, then one
   ``scatter_reduce_(..., "amax")``), which the port never calls.
8. end to end, row-sparse dist: phase 6's service and stream again with
   ``dist_layout="row_sparse", dist_cap=4`` (rows overflow into the
   table, drains grow and re-pack). Asserts every query's per-event result
   log equals phase 6's and the reference engine's, the same
   frontier dispatches and fallbacks as phase 6 (at least one: the densify
   round trip runs), at least one drain and one re-pack with nothing lost,
   B6 launched once per frontier insert dispatch that did not fall back,
   B5 once per closure round and B1 never.
9. B6 at the path's shapes: on phase 8's final state (the Q*F slot rows
   with the most entries, E = N*K) and at a synthetic M=4096, C=64,
   E=32768, ``torch.equal`` against the plain version; device times (the
   median of CUDA events around three replays of a CUDA graph of the
   calls) of B6 and of the
   PyTorch yardstick
   (``torch.full(-inf).scatter_reduce_(1, idx, ts, "amax")``, which the
   port never calls: its fill and scatter kernels) beside the bound, the
   CUDA-event times per call with the host's enqueue included, the
   wrapper's host microseconds per call, and the plain version.
10. end to end, the bucket backend: phase 4's and then phase 8's service
   configuration with the 11 Table-2 queries registered with
   ``backend=BucketBackend(n_levels=8)`` (step 2.5 s), each fed the whole
   stream of that phase (its main run, then its traced window). The
   float service of phase 4 or 8 is the bucket run's twin: it got the
   same sgts, ran B1 or B5 once per round and equalled its reference
   RAPQ engines. Asserts that every reference result pair is in the
   bucket run's results; at the end, that the bucket's currently valid
   pairs contain the twin's and each extra pair's true bottleneck (the
   twin's dist) lies within one level step below its query's threshold,
   and that the bucket dist equals the twin's dist mapped through the
   level grid (the origin-free guard); that on the dense adjacency B3 ran
   once per bucket closure round (B1, B5 and B6 never), and on phase 8's
   ELL adjacency and row-sparse dist B5's int32 entry ran once per round
   and B6 once per frontier insert that did not fall back (B1 and B3
   never). Each
   run's last window (the twin's traced sgts) runs under
   ``torch.profiler``: its top device kernels.
11. B3, B4, B2 and B5 on int32 levels against their plain versions
   (``torch.equal``) on the test shapes and at the path's shapes (B3 at
   (J, 2048, 2048, 2048, T=9) and at the frontier's m in {4, 32}; B2 and
   B4 at 2048^3; B5-int32 at phase 6's frontier shape, on phase 6's
   operands encoded to levels); CUDA-event times beside the bound (the
   larger of bytes over 3.35 TB/s and 2*J*m*k*n*T int8 operations over
   1979 TOP/s for B3/B4), the plain version and the library yardstick (T
   ``torch.bmm`` calls on bf16 0/1 operands, then the compare and sum),
   which the port never calls.
12. the legacy single-query round: phase 4's final dense adjacency and
   Q1's DFA at n_slots=2048. ``closure`` from -inf with the "cuda"
   backend (B2) is ``torch.equal`` to "plain", with B2 launched once per
   transition per round; the same with ``BucketBackend`` (B4) on encoded
   levels against its plain versions, whose decoded result is the float
   closure mapped through the grid; ``valid_pairs`` at phase 4's clock
   equals phase 4's dense engine's valid pairs for Q1.

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

# tests/test_torch_gpu.py: B5_CASES (J, M, U, E), B6_CASES (M, C, E, keys)
B5_CASES = [(2, 5, 12, 3), (1, 1, 9, 1), (3, 7, 13, 2), (4, 16, 33, 4),
            (1, 130, 257, 8), (48, 4, 2048, 2), (6, 300, 700, 5)]
B6_CASES = [(12, 4, 30, "random"), (5, 1, 33, "random"), (9, 16, 257, "random"),
            (7, 8, 40, "random"), (3, 64, 100, "random"), (40, 256, 4097, "random"),
            (17, 128, 2049, "random"), (192, 4, 32768, "random"),
            (9, 64, 8193, "random"), (11, 32, 8194, "random"), (13, 16, 8195, "random"),
            (7, 256, 12291, "boundary"), (6, 1, 8197, "boundary"),
            (5, 64, 4098, "boundary"), (8, 16, 9001, "free"), (3, 256, 4096, "free")]
KERNELS = ("maxmin", "ell", "rowsparse", "bucket")
SKINNY_M = (4, 32)        # frontier rows of B1's skinny slabs
# tests/test_torch_gpu.py: B1 on block-sparse operands, whole tiles of the
# kernel's (128 x 16 of a, 16 x 128 of b) all -inf
SPARSE_PATTERNS = ("a_tiles", "b_tiles", "both_tiles", "all_neg_inf", "corners",
                   "signed", "one_negative")
SPARSE_SHAPES = [(2, 300, 260, 270), (3, 4, 2048, 300), (2, 32, 1000, 512)]
A_TILE, B_TILE = (128, 16), (16, 128)
RATE_OPS = ("FFMA", "FMNMX", "VIMNMX", "VIMNMX3")  # minmax_rate's op 0..3

PROFILE_SGTS = 24         # sgts of the traced window after the main run
CONFLICT_BEFORE_END = 40  # inserts of the main run after the Q3 conflict
PEAK_F32_OPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12   # H100 SXM, dense int8 on the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
BUCKET_LEVELS = 8         # phase 10's BucketBackend(n_levels=8): T = 9
ELL_SLOTS = 8192          # the frontier + ELL service's n_slots (phases 6-10)
ELL_LAYOUT = dict(frontier="auto", frontier_cap=4, adj_layout="ell", ell_cap=2)
RS_DIST = dict(dist_layout="row_sparse", dist_cap=4)   # phases 8 and 10


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


def bound_ell_ms(j: int, m: int, u: int, e: int, live_candidates: int):
    """(bound in ms, "bytes" | "operations") of one ELL gather-contract:
    d (J, M, U) read and the (J, M, U) output written once, idx/ts
    (J, U, E) read once, against one min and one max per candidate that
    this run's data holds (finite d entries times E slots)."""
    t_bytes = (4 * (j * m * u + j * m * u) + 8 * j * u * e) / PEAK_BYTES
    t_ops = 2.0 * live_candidates / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def trace_window(torch, run, n_sgts: int, tag: str, top: int = 6) -> None:
    """Run ``run()`` under ``torch.profiler`` (device activity only:
    recording every CPU-side op of the host loop tripled the window's wall
    time) and print the top device kernels by self device time, with the
    window's total device time and wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    total = sum(by_name.values()) / 1e3
    print(f"[{tag}] top device kernels over {n_sgts} traced sgts"
          f"{'' if by_name else ': the profiler recorded no device time'}; "
          f"device time {total:.3f} ms in {wall * 1e3:.3f} ms traced wall",
          flush=True)
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[{tag}]   {us / 1e3:10.3f} ms  {key[:90]}", flush=True)


def by_event(log):
    """A result log of (event time, pair) as {event time: pairs}: the
    per-event result stream, whatever order an event emits its pairs in."""
    out = {}
    for t, pair in log:
        out.setdefault(float(t), set()).add(pair)
    return out


def bound_b6_ms(m: int, c: int, e: int, live_slots: int):
    """(bound in ms, "bytes" | "operations") of one row-sparse gather: the
    (M, E) output written once and idx/ts (M, C) read once, against one
    max per finite slot this run's data holds."""
    t_bytes = (4 * m * e + 8 * m * c) / PEAK_BYTES
    t_ops = float(live_slots) / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def block_sparse(torch, gen, a, b, pattern: str):
    """a and b with whole kernel tiles set to -inf: about 70% of a's
    (128 x 16) tiles ("a_tiles"), of b's (16 x 128) tiles ("b_tiles") or of
    both, each operand keeping its first k tile; everything ("all_neg_inf");
    or everything but the four corner entries of every tile ("corners").
    Or values with the sign bit set, which send a block from the integer
    compare path to the float one: all shifted down by 500 ("signed"), or
    a's tiles cleared and one entry of its kept first k tile set to -3
    ("one_negative")."""
    ninf = float("-inf")
    if pattern == "all_neg_inf":
        return torch.full_like(a, ninf), torch.full_like(b, ninf)
    if pattern == "signed":
        return a - 500, b - 500
    if pattern == "one_negative":
        a = block_sparse(torch, gen, a, b, "a_tiles")[0]
        a[0, a.shape[1] // 2, 1 % a.shape[2]] = -3.0
        return a, b
    out = []
    for x, tile, k_axis, clear in ((a, A_TILE, 2, pattern in ("a_tiles", "both_tiles")),
                                   (b, B_TILE, 1, pattern in ("b_tiles", "both_tiles"))):
        j, r, c = x.shape
        tr, tc = tile
        if pattern == "corners":
            keep = torch.zeros((r, c), dtype=torch.bool, device=x.device)
            for r0 in range(0, r, tr):
                for c0 in range(0, c, tc):
                    for rr in (r0, min(r0 + tr, r) - 1):
                        keep[rr, [c0, min(c0 + tc, c) - 1]] = True
            x = x.masked_fill(~keep, ninf)
        elif clear:
            gone = torch.rand((j, -(-r // tr), -(-c // tc)), generator=gen,
                              device=x.device) < 0.7
            if k_axis == 2:
                gone[:, :, 0] = False
            else:
                gone[:, 0, :] = False
            gone = gone.repeat_interleave(tr, 1)[:, :r].repeat_interleave(tc, 2)[:, :, :c]
            x = x.masked_fill(gone, ninf)
        out.append(x.contiguous())
    return out[0], out[1]


def sass_counts(lib_path: str, kernel_name: str, opcodes):
    """Per kernel of the library whose mangled name holds ``kernel_name``,
    how often each opcode stem in ``opcodes`` occurs in its SASS
    (``cuobjdump -sass``); None where cuobjdump is missing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel_name in name:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", part)
            out[name] = {op: sum(1 for o in ops if o.split(".")[0] == op)
                         for op in opcodes}
    return out


def minmax_rates(torch):
    """Phase 3's instruction-rate microbenchmark (``minmax_rate_kernel`` in
    maxmin.cu): one wave of blocks, each thread running 8 independent
    chains of one instruction, launched 50 times back to back. Prints and
    returns, per instruction, lane operations per second (CUDA events), the
    SM clock ``nvidia-smi`` reads while the launches run, and from the two
    the lanes and warp instructions per clock per SM; then the
    instruction counts in the SASS of the benchmark and of B1's product
    kernels."""
    import ctypes

    from repro_torch.kernels import build

    run = build.bind("maxmin", "minmax_rate", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    per_sm_of = build.bind("maxmin", "minmax_rate_blocks_per_sm", [ctypes.c_int])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, chains, unroll, iters, reps = 256, 8, 16, 4096, 50
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for op, name in enumerate(RATE_OPS):
        per_sm = per_sm_of(op)
        if per_sm < 1:
            fail(f"minmax_rate_blocks_per_sm({op}) returned {per_sm}")
        blocks = sms * per_sm
        sink = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
        if run(op, blocks, 16, 1, sink.data_ptr(), stream):
            fail(f"minmax_rate {name} did not launch")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(op, blocks, iters, 1, sink.data_ptr(), stream)
        end.record()
        time.sleep(0.02)            # the launches are running: read the clock
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        ops_per_s = blocks * threads * iters * unroll * chains / (ms / 1e3)
        lanes = ops_per_s / (sms * mhz * 1e6)
        rates[name] = {"ops_per_s": ops_per_s, "sm_clock_mhz": mhz,
                       "lanes_per_clk_per_sm": lanes,
                       "warp_instr_per_clk_per_sm": lanes / 32, "ms": ms,
                       "blocks_per_sm": per_sm}
        print(f"[rate] {name}: {ops_per_s / 1e12:.3f} T lane-ops/s at {mhz:.0f} MHz "
              f"(nvidia-smi, during the run) = {lanes:.1f} lanes, "
              f"{lanes / 32:.3f} warp instructions per clock per SM "
              f"({per_sm} blocks of 256 per SM, {ms:.3f} ms a launch)", flush=True)
    lib = str(build.library_path("maxmin"))
    for kernel, ops in (("minmax_rate_kernel", ("FFMA", "FMNMX", "VIMNMX", "VIMNMX3")),
                        ("maxmin_fused_kernel", ("FMNMX", "VIMNMX", "VIMNMX3", "LDS",
                                                 "LDGSTS", "BAR"))):
        counts = sass_counts(lib, kernel, ops)
        if counts is None:
            print("[rate] SASS: cuobjdump not found", flush=True)
        for fn, c in (counts or {}).items():
            print(f"[rate] SASS {fn[-40:]}: {c}", flush=True)
    return rates


def b1_on_path_operands(torch, d_s, a_l):
    """After phase 4: B1 on the run's own last-round operands, d_s (J, N, N)
    the final dist gathered per transition row and a_l (J, N, N) the
    adjacency rows of their labels. torch.equal against the plain version;
    CUDA-event times beside the bound counted from what these inputs need
    (the bytes of both inputs and the output, against one min and one max
    per (j, i, k, n) with both a[j, i, k] and b[j, k, n] finite), the
    share of k tiles the pre-pass lists, and the plain version. Frees the
    operands."""
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref

    j, m, k = d_s.shape
    n = a_l.shape[2]
    out = b1.maxmin_matmul_fused(d_s, a_l)
    ref = maxmin_matmul_fused_ref(d_s, a_l)
    if not torch.equal(out, ref):
        fail("B1 differs from its plain version on phase 4's own operands")
    del out, ref
    fin_a = d_s > float("-inf")
    fin_b = a_l > float("-inf")
    triples = int((fin_a.sum(1, dtype=torch.float64)
                   * fin_b.sum(2, dtype=torch.float64)).sum())
    # the tiles the pre-pass flags, and the k steps the product runs
    rt, kt, ct = -(-m // 128), -(-k // 16), -(-n // 128)
    pad_a = torch.nn.functional.pad(fin_a, (0, kt * 16 - k, 0, rt * 128 - m))
    pad_b = torch.nn.functional.pad(fin_b, (0, ct * 128 - n, 0, kt * 16 - k))
    live_a = pad_a.view(j, rt, 128, kt, 16).any(4).any(2)        # (J, RT, KT)
    live_b = pad_b.view(j, kt, 16, ct, 128).any(4).any(2)        # (J, KT, CT)
    steps = int((live_a.to(torch.float32) @ live_b.to(torch.float32)).sum())
    del fin_a, fin_b, pad_a, pad_b
    ms = time_cuda(torch, lambda: b1.maxmin_matmul_fused(d_s, a_l), 20)
    plain = time_cuda(torch, lambda: maxmin_matmul_fused_ref(d_s, a_l), 1)
    t_bytes = 4 * (j * m * k + j * k * n + j * m * n) / PEAK_BYTES
    t_ops = 2.0 * triples / PEAK_F32_OPS
    bms, by = max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    row = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bms,
           "bound_by": by, "shape": [j, m, k, n],
           "live_a_tiles": float(live_a.float().mean()),
           "live_b_tiles": float(live_b.float().mean()),
           "k_steps_run": steps / float(j * rt * ct * kt)}
    print(f"[kernel] B1 on phase 4's last-round operands J={j} m={m} k={k} n={n}: "
          f"{row['live_a_tiles']:.4f} of a's and {row['live_b_tiles']:.4f} of b's "
          f"tiles hold an entry, {row['k_steps_run']:.4f} of the k steps run; "
          f"{triples} finite (a, b) pairs; {ms:.3f} ms, bound {bms:.3f} ms ({by}), "
          f"{100 * bms / ms:.1f}% of bound; plain {plain:.3f} ms; == plain "
          "(torch.equal)", flush=True)
    del d_s, a_l, live_a, live_b
    torch.cuda.empty_cache()
    return row


def ptxas_summary(name: str):
    """nvcc seconds and the largest registers, shared memory and spill
    stores ptxas printed for any kernel of ``csrc/<name>.cu``."""
    from repro_torch.kernels import build

    info = build.BUILD_INFO[name]
    log = str(info["log"])

    def most(pat):
        return max([int(x) for x in re.findall(pat, log)] or [0])

    return {"build_s": info["seconds"], "registers": most(r"Used (\d+) registers"),
            "smem_bytes": most(r"(\d+) bytes smem"),
            "spill_bytes": most(r"(\d+) bytes spill stores")}


def print_build_log(name: str, info) -> None:
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {name}: {line.strip()}", flush=True)


def graph_ms(torch, fn, reps: int, replays: int = 3):
    """Device time per call from CUDA events around each of ``replays``
    replays of a CUDA graph of ``reps`` calls (captured after a warm-up
    call on a side stream): the calls run back to back, without the host's
    enqueue. Returns (median, every replay's ms per call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    each = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        each.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(each)[len(each) // 2], each


def host_us(torch, fn, reps: int) -> float:
    """Mean host microseconds per call to enqueue ``fn`` (no synchronise
    inside the timed loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


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
                    help="insert sgts of the dense end-to-end stream (>= 256)")
    ap.add_argument("--ell-inserts", type=int, default=2048,
                    help="insert sgts of the frontier + ELL stream (>= 256)")
    args = ap.parse_args()
    if min(args.edges, args.ell_inserts) < 256:
        fail("--edges and --ell-inserts must be at least 256")
    if not all((ROOT / "src" / "repro_torch" / "csrc" / f"{k}.cu").is_file()
               for k in KERNELS):
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
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.ell.ref import ell_gather_contract_ref
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.maxmin.ref import maxmin_matmul_fused_ref
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.kernels.rowsparse.ref import rowsparse_gather_ref
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService, RSPQFallback
    from repro_torch.streaming.stream import SGT, Stream

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all(KERNELS)   # one nvcc each, started together
    for name in KERNELS:
        build.load(name)
    print(f"[build] maxmin.cu, ell.cu, rowsparse.cu and bucket.cu: "
          f"{time.perf_counter() - t0:.3f} s wall", flush=True)
    for name in KERNELS:
        info = build.BUILD_INFO[name]
        print(f"[build] {name}.cu: nvcc {info['seconds']:.3f} s -> "
              f"{info['path']}", flush=True)
        print_build_log(name, info)

    # -- 3. kernel against its plain version -----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand_ts(shape, dtype, density=0.7):
        x = torch.rand(shape, generator=gen, device="cuda") * 1000.0
        x[torch.rand(shape, generator=gen, device="cuda") > density] = float("-inf")
        return x.to(dtype)

    max_err = 0.0

    def check(j, m, k, n, dtype, sparse=None):
        nonlocal max_err
        a, b = rand_ts((j, m, k), dtype), rand_ts((j, k, n), dtype)
        a[:, : max(1, m // 7)] = float("-inf")        # all -inf rows
        if sparse is not None:
            a, b = block_sparse(torch, gen, a, b, sparse)
        out = b1.maxmin_matmul_fused(a, b)
        torch.cuda.synchronize()
        ref = maxmin_matmul_fused_ref(a, b)
        same = out == ref
        err = (out.float() - ref.float()).abs().masked_fill(same, 0.0)
        err = float(err.max()) if err.numel() else 0.0
        max_err = max(max_err, err)
        if not torch.equal(out, ref):
            fail(f"B1 differs from its plain version at J={j} m={m} k={k} "
                 f"n={n} {dtype}{f' {sparse}' if sparse else ''}: max |err| {err}")

    n_checks = 0
    for dtype in (torch.float32, torch.float16):
        for (m, k, n) in SHAPES:
            check(1, m, k, n, dtype)
            n_checks += 1
        for (j, m, k, n) in ODD_SHAPES:
            check(j, m, k, n, dtype)
            n_checks += 1
        for pattern in SPARSE_PATTERNS:
            for (j, m, k, n) in SPARSE_SHAPES:
                check(j, m, k, n, dtype, sparse=pattern)
                n_checks += 1
    print(f"[kernel] B1 == plain (torch.equal) on {n_checks} test shapes, "
          f"float32 and float16, {len(SPARSE_PATTERNS)} operand patterns "
          f"({', '.join(SPARSE_PATTERNS)}) on {SPARSE_SHAPES}", flush=True)
    for m in SKINNY_M:
        check(48, m, 2048, 2048, torch.float32)
        check(48, m, 2048, 2048, torch.float32, sparse="both_tiles")
    print(f"[kernel] B1 == plain (torch.equal) at the frontier's skinny slabs "
          f"J=48 m in {SKINNY_M} k=n=2048 float32, uniform and block-sparse",
          flush=True)
    rates = minmax_rates(torch)

    ell_err = 0.0

    def check_b5(d, idx, ts, what: str) -> None:
        nonlocal ell_err
        out = b5.ell_gather_contract(d, idx, ts)
        torch.cuda.synchronize()
        ref = ell_gather_contract_ref(d, idx, ts)
        if not torch.equal(out, ref):   # equal means max |err| 0.0 exactly
            err = (out - ref).abs().masked_fill(out == ref, 0.0)
            ell_err = max(ell_err, float(err.max()))
            fail(f"B5 differs from its plain version at {what}: max |err| "
                 f"{ell_err}")

    for (j, m, u, e) in B5_CASES:
        d = rand_ts((j, m, u), torch.float32, density=0.4)
        idx = torch.randint(0, u, (j, u, e), generator=gen, device="cuda",
                            dtype=torch.int32)
        idx[:, :, 0] = idx[:, :, -1]                  # duplicate destinations
        ts = rand_ts((j, u, e), torch.float32, density=0.6)
        ts[:, : max(1, u // 7)] = float("-inf")       # all-free rows
        check_b5(d, idx, ts, f"J={j} M={m} U={u} E={e}")
    print(f"[kernel] B5 == plain (torch.equal) on {len(B5_CASES)} test shapes",
          flush=True)

    rs_err = 0.0

    def check_b6(idx, ts, e: int, what: str) -> None:
        nonlocal rs_err
        out = b6.rowsparse_gather(idx, ts, e)
        torch.cuda.synchronize()
        ref = rowsparse_gather_ref(idx, ts, e)
        if not torch.equal(out, ref):   # equal means max |err| 0.0 exactly
            err = (out - ref).abs().masked_fill(out == ref, 0.0)
            rs_err = max(rs_err, float(err.max()))
            fail(f"B6 differs from its plain version at {what}: max |err| "
                 f"{rs_err}")

    for (m, c, e, keys) in B6_CASES:
        idx, ts = b6_operands(torch, gen, m, c, e, keys)
        check_b6(idx, ts, e, f"M={m} C={c} E={e} keys {keys}")
    print(f"[kernel] B6 == plain (torch.equal) on {len(B6_CASES)} test shapes "
          "(duplicate stale keys, duplicates across the 4096-column tile edges, "
          "all-free rows and operands, C=1 to 256, E % 4 in 0..3)", flush=True)

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
    minmax = rates["FMNMX"]["ops_per_s"]
    # uniform operands (density 0.7) in [0, 1000): every tile on the integer
    # compare path, 1.5 min/max instructions per (i, k, n); "signed" shifts
    # them to [-500, 500): the float path, 2 per (i, k, n)
    for tag, m_t, n_t, reps in (("uniform", N, N, 5), ("signed", N, N, 5),
                                ("uniform", 2 * N, 2 * N, 2),
                                *(("uniform", m, N, 20) for m in SKINNY_M)):
        a = rand_ts((J, m_t, n_t), torch.float32)
        b = rand_ts((J, n_t, n_t), torch.float32)
        if tag == "signed":
            a, b = a - 500, b - 500
        ms = time_cuda(torch, lambda: b1.maxmin_matmul_fused(a, b), reps)
        bms, by = bound_ms(J, m_t, n_t, n_t)
        per = 2.0 if tag == "signed" else 1.5
        at_rate = per * J * m_t * n_t * n_t / minmax * 1e3
        plain = None
        if (tag, n_t, m_t) == ("uniform", N, N):
            plain = time_cuda(torch, lambda: maxmin_matmul_fused_ref(a, b), 1)
        timings[(tag, n_t, m_t)] = (ms, bms, by, plain, at_rate)
        print(f"[kernel] B1 {tag} J={J} m={m_t} k=n={n_t}: {ms:.3f} ms, bound "
              f"{bms:.3f} ms ({by}), {100 * bms / ms:.1f}% of bound; {per} min/max "
              f"per (i, k, n) at the measured FMNMX rate {at_rate:.3f} ms, "
              f"{100 * at_rate / ms:.1f}%; plain "
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
    b5.ell_gather_contract.launches = 0
    t0 = time.perf_counter()
    report = svc.ingest(Stream(tuples), record_latency=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b1.maxmin_matmul_fused.launches
    if b5.ell_gather_contract.launches:
        fail("kernel B5 ran on the dense-adjacency path")
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
    # B1 on this run's own last-round operands (the final state's gathered
    # dist slabs and adjacency rows), beside what they need
    btt = group.btt
    b1_path = b1_on_path_operands(
        torch, ex.arrays.dist[btt.qidx, :, :, btt.src].contiguous(),
        ex.dense_adj()[btt.lab].contiguous())
    ms_b1 = b1_path["ms"]
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
          f"({launches / len(tuples):.3f} per sgt); B1 on the last round's "
          f"operands {ms_b1:.3f} ms x {launches} = {launches * ms_b1 / 1e3:.3f} s "
          f"of {wall:.3f} s wall", flush=True)
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
    # phase 12's operands: the final dense adjacency, the clock and Q1's
    # currently valid pairs
    legacy_in = {"adj": ex.dense_adj().clone(), "labels": list(group.labels),
                 "now": ex.arrays.now.clone(), "window": window,
                 "valid": ex.emit(group.tables)[group.lane_of("Q1")].clone()}

    # -- 5. a traced window of the same path -----------------------------------
    trace_window(torch, lambda: svc.ingest(Stream(tail), record_latency=True),
                 len(tail), "trace")
    # phase 10's float twin: this service's final state and its sgts
    dense_twin = float_twin(torch, svc, group, queries, tuples, tail)

    del svc, group, ex
    torch.cuda.empty_cache()

    # -- 6. end to end: frontier + ELL at n_slots=8192 ---------------------------
    ell = ell_phase(torch, queries, args.ell_inserts, device=None)

    # -- 7. B5 at the path's shapes, on this run's operands ---------------------
    b5_rows = b5_at_path_shapes(torch, ell, check_b5)
    print(f"[kernel] B5 == plain (torch.equal) on every shape; max |err| "
          f"{ell_err}", flush=True)

    # -- 8. end to end: the row-sparse dist, phase 6's service and stream -------
    rs = ell_phase(torch, queries, args.ell_inserts, device=None, **RS_DIST,
                   against=ell)

    # -- 9. B6 at the path's shapes, on this run's operands ---------------------
    b6_rows = b6_at_path_shapes(torch, gen, rs, check_b6)
    print(f"[kernel] B6 == plain (torch.equal) on every shape; max |err| "
          f"{rs_err}", flush=True)

    # -- 10. end to end: the bucket backend, against phases 4 and 6 -------------
    bk = bucket_phase(torch, queries, dense_twin, n_slots, "bucket", device=None)
    del dense_twin
    bk_rs = bucket_phase(torch, queries, rs.pop("twin"), ELL_SLOTS, "bucket-rs",
                         device=None, **ELL_LAYOUT, **RS_DIST)

    # -- 11. B3, B4, B2 and B5-int32 against their plain versions, timed -------
    lvl_rows = level_kernels_phase(torch, gen, bk["J"], n_slots, b5_rows)

    # -- 12. the legacy single-query round --------------------------------------
    legacy = legacy_phase(torch, queries["Q1"], legacy_in, device=None)

    e5, b6p = b5_rows["dense"], b6_rows["path"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")

    def row(name, src, replaces, launches, err, data):
        """One kernel's JSON entry, with its source's nvcc seconds and
        ptxas' registers, shared memory and spill stores."""
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                **{k: data.get(k) for k in keys}, **ptxas_summary(src)}

    kernels = [
        # B1's numbers are on the main path's own operands (phase 4's last
        # round); its uniform-operand times, the rate microbenchmark and the
        # other readings ride along
        {**row("B1 maxmin_matmul_fused", "maxmin",
               "src/repro/kernels/maxmin/maxmin.py:138", launches, max_err, b1_path),
         "path_operands": {k: b1_path[k] for k in b1_path if k not in keys},
         "uniform": [{"operands": tag, "shape": [J, m_t, n_t, n_t], "ms": t[0],
                      "bound_ms": t[1], "bound_by": t[2], "plain_ms": t[3],
                      "at_measured_minmax_rate_ms": t[4]}
                     for (tag, n_t, m_t), t in timings.items()],
         "minmax_rate": rates},
        row("B2 maxmin_matmul", "maxmin", "src/repro/kernels/maxmin/maxmin.py:67",
            legacy["b2_launches"], lvl_rows["B2"]["max_abs_err"], lvl_rows["B2"]),
        row("B3 bucket_maxmin_fused", "bucket",
            "src/repro/kernels/bucket/bucket.py:93", bk["launches"][0],
            lvl_rows["B3"]["max_abs_err"], lvl_rows["B3"]),
        row("B4 bucket_maxmin", "bucket", "src/repro/kernels/bucket/bucket.py:24",
            legacy["b4_launches"], lvl_rows["B4"]["max_abs_err"], lvl_rows["B4"]),
        {**row("B5 ell_gather_contract", "ell", "src/repro/kernels/ell/ell.py:39",
               ell["launches"], ell_err, e5),
         # the int32 entry (bucket levels): its launches in phase 10's
         # ELL + row-sparse run, every one of that run's rounds
         "s32": {"launches": bk_rs["launches"][2],
                 "max_abs_err": lvl_rows["B5-int32"]["max_abs_err"],
                 **{k: lvl_rows["B5-int32"][k] for k in keys}}},
        {**row("B6 rowsparse_gather", "rowsparse",
               "src/repro/kernels/rowsparse/rowsparse.py:40", rs["b6_launches"],
               rs_err, b6p),
         # ms and library_ms are device times; per call with the host's
         # enqueue, the host's time per call, and the synthetic shape beside
         "per_call": {k: b6p[k] for k in b6p if k not in keys},
         "synthetic": b6_rows["synthetic"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def ell_phase(torch, queries, n_inserts: int, device=None, n_slots: int = ELL_SLOTS,
              dist_layout: str = "dense", dist_cap: int = 16, against=None):
    """Phase 6 (``dist_layout="dense"``) and phase 8 (``"row_sparse"``):
    the frontier + ELL service path at ``n_slots`` against the reference
    RAPQ engines, with its launch counts, telemetry and checks; phase 8
    also against phase 6's returned run (``against``). ``device`` and
    ``n_slots`` let the same code rehearse on the CPU at a small size; the
    script itself runs it on the card at 8192. Returns the run's result
    logs and counts, and its final operands for phase 7 or 9."""
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.stream import Stream

    on_card = device is None
    row_sparse = dist_layout == "row_sparse"
    tag = "rs" if row_sparse else "ell"
    window, slide = 20.0, 2.0
    svc = PersistentQueryService(window=window, slide=slide, **ELL_LAYOUT,
                                 dist_layout=dist_layout, dist_cap=dist_cap,
                                 device=device)
    for name, expr in queries.items():
        svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
        svc.register(f"{name}_ref", expr, engine="reference")
    group = svc.queries["Q1"]
    ex = group.executor
    J, N, K, Q = (group.btt.qidx.shape[0], group.n_slots, group.k, group.q_cap)
    # n_inserts for the main run, then PROFILE_SGTS more for a traced window
    all_tuples = list(with_deletions(so_like(
        n_vertices=n_slots, n_edges=n_inserts + PROFILE_SGTS, seed=7,
        rate=50.0), ratio=0.02, seed=5))
    cut = [i for i, s in enumerate(all_tuples) if s.op == "+"][n_inserts]
    tuples, tail = all_tuples[:cut], all_tuples[cut:]
    n_del = sum(1 for s in tuples if s.op == "-")
    print(f"[{tag}] frontier='auto' F=4, adj_layout='ell' E=2, spill ring "
          f"{ex.spill_cap}, dist_layout={dist_layout!r}"
          f"{f' dist_cap={dist_cap}' if row_sparse else ''}: {Q} lanes, J={J}, "
          f"K={K}, N={N}; {n_inserts} inserts + {n_del} deletions = "
          f"{len(tuples)} sgts over {tuples[-1].ts:.3f} s of stream time",
          flush=True)
    rounds0, steps0, syncs0 = ex.rounds_total, ex.steps, group.host_syncs
    f0 = ex.frontier_stats
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    b1.maxmin_matmul_fused.launches = 0
    b5.ell_gather_contract.launches = 0
    b6.rowsparse_gather.launches = 0
    t0 = time.perf_counter()
    report = svc.ingest(Stream(tuples), record_latency=True)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b5.ell_gather_contract.launches
    b1_launches = b1.maxmin_matmul_fused.launches
    b6_launches = b6.rowsparse_gather.launches
    rounds = ex.rounds_total - rounds0
    steps = ex.steps - steps0
    syncs = group.host_syncs - syncs0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    fst = {k: (v - f0[k] if k in ("dispatches", "fallbacks", "rows_relaxed",
                                  "delete_dispatches", "delete_fallbacks",
                                  "seed_rows", "dense_row_equiv") else v)
           for k, v in ex.frontier_stats.items()}
    ast = ex.adjacency_stats
    logs = {name: list(group.per_query_log[group.lane_of(name)])
            for name in queries}

    if b1_launches:
        fail(f"kernel B1 ran {b1_launches} times on the {tag} path")
    if on_card and (launches <= 0 or launches != rounds):
        fail(f"B5 launches ({launches}) != closure rounds run ({rounds})")
    mismatched = [name for name in queries
                  if svc.results(name) != svc.results(f"{name}_ref")
                  or by_event(logs[name])
                  != by_event(svc.queries[f"{name}_ref"].result_log)]
    if mismatched:
        fail(f"{tag}-path results differ from the reference RAPQ for {mismatched}")
    n_results = {name: len(svc.results(name)) for name in queries}
    if sum(n_results.values()) == 0:
        fail(f"no query produced any result on the {tag} path")
    if not fst["dispatches"] > fst["fallbacks"] >= 1:
        fail(f"expected frontier dispatches > fallbacks >= 1, got {fst}")
    if fst["delete_dispatches"] - fst["delete_fallbacks"] < 1:
        fail(f"no delete went through the cone: {fst}")
    if ast["spill_drains"] < 1 or ast["repacks"] < 1:
        fail(f"the spill ring never drained and re-packed: {ast}")
    dst = ex.dist_stats
    if row_sparse:
        inserts_kept = ((fst["dispatches"] - fst["delete_dispatches"])
                        - (fst["fallbacks"] - fst["delete_fallbacks"]))
        if on_card and b6_launches != inserts_kept:
            fail(f"B6 launches ({b6_launches}) != frontier insert dispatches "
                 f"that did not fall back ({inserts_kept})")
        lost = int(ex.arrays.dist.lost)
        if dst["drains"] < 1 or dst["repacks"] < 1 or lost or dst["lost"]:
            fail(f"expected >= 1 drain and re-pack and nothing lost: {dst}, "
                 f"device lost {lost}")
    elif b6_launches:
        fail(f"kernel B6 ran {b6_launches} times on the dense-dist path")
    if against is not None:
        if logs != against["logs"]:
            fail(f"{tag} per-event result logs differ from phase 6's for "
                 f"{[n for n in queries if logs[n] != against['logs'][n]]}")
        if report.invalidated != against["invalidated"]:
            fail(f"{tag} deletion invalidations differ from phase 6's")
        for key in ("dispatches", "fallbacks", "delete_dispatches",
                    "delete_fallbacks", "seed_rows", "max_lane_rows"):
            if fst[key] != against["frontier"][key]:
                fail(f"{tag} frontier {key} {fst[key]} != phase 6's "
                     f"{against['frontier'][key]}")

    lat = sorted(svc.stats["Q1"].latencies_us)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
    dense_s = sum(svc.stats["Q1"].latencies_us) / 1e6
    ref_s = sum(sum(svc.stats[f"{name}_ref"].latencies_us)
                for name in queries) / 1e6
    print(f"[{tag}] {len(tuples)} sgts in {wall:.3f} s = {len(tuples) / wall:.3f} "
          f"sgts/s; dispatch p50 {p50 / 1e3:.3f} ms, p99 {p99 / 1e3:.3f} ms; "
          f"slowest five {[round(x / 1e3, 3) for x in lat[-5:]]} ms",
          flush=True)
    print(f"[{tag}] {steps} dispatches, {rounds} closure rounds ({rounds / steps:.3f} "
          f"per dispatch), host syncs {syncs / steps:.3f} per dispatch; B5 "
          f"launches {launches} (one per round), B1 launches {b1_launches}, "
          f"B6 launches {b6_launches}", flush=True)
    print(f"[{tag}] frontier: {fst['dispatches']} dispatches, {fst['fallbacks']} "
          f"dense fallbacks ({fst['delete_dispatches']} deletes, "
          f"{fst['delete_fallbacks']} of them fell back); rows relaxed "
          f"{fst['rows_relaxed']} = {fst['rows_relaxed'] / max(steps, 1):.3f} per "
          f"dispatch ({fst['dense_row_equiv']} for the dense loop); seed rows "
          f"{fst['seed_rows']}, largest lane frontier {fst['max_lane_rows']}; "
          f"final frontier_cap {fst['cap']}", flush=True)
    print(f"[{tag}] adjacency: final ell_cap {ast['ell_cap']}, spill ring "
          f"{ast['spill_cap']}, {ast['spill_drains']} drains, {ast['repacks']} "
          f"re-packs, {ast['live_edges']} live edges at the last re-pack, "
          f"{ast['adj_bytes']} bytes", flush=True)
    if row_sparse:
        print(f"[{tag}] dist: final dist_cap {dst['dist_cap']}, ovf_cap "
              f"{dst['ovf_cap']}, {dst['drains']} drains, {dst['repacks']} "
              f"re-packs, lost {dst['lost']}, {dst['live_entries']} live entries "
              f"at the last re-pack, occupancy {dst['occupancy']}, "
              f"{dst['dist_bytes']} bytes", flush=True)
    print(f"[{tag}] wall split (host clock): dense-group dispatches {dense_s:.3f} s, "
          f"11 reference RAPQ engines {ref_s:.3f} s, rest "
          f"{wall - dense_s - ref_s:.3f} s; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    print(f"[{tag}] results per query: {n_results}; deletions {report.deletions}; "
          f"results and per-event result logs == reference RAPQ for all 11 "
          f"queries"
          f"{'; per-event result logs == phase 6' if against else ''}",
          flush=True)

    if on_card:
        trace_window(torch, lambda: svc.ingest(Stream(tail), record_latency=True),
                     len(tail), f"{tag}-trace", top=10)

    out = {"launches": launches, "b6_launches": b6_launches, "logs": logs,
           "invalidated": report.invalidated, "frontier": fst,
           "frontier_cap": ex.frontier_cap}
    if row_sparse:
        # phase 10's float twin: this service's final state and its sgts
        out["twin"] = float_twin(torch, svc, group, queries, tuples,
                                 tail if on_card else [])
    a = ex.arrays
    if row_sparse:
        # phase 9's operands: each lane's F slot rows with the most entries
        sd = a.dist
        q, n, c = sd.idx.shape
        top = torch.topk((sd.ts > float("-inf")).sum(dim=2), ex.frontier_cap,
                         dim=1).indices
        key = (torch.arange(q, device=top.device)[:, None] * n + top).reshape(-1)
        out.update(sid=sd.idx.view(q * n, c).index_select(0, key).contiguous(),
                   sts=sd.ts.view(q * n, c).index_select(0, key).contiguous(),
                   e=n * sd.k)
    else:
        # the final operands of a round, for phase 7
        btt = group.btt
        labs = btt.lab
        out.update(d=a.dist[btt.qidx, :, :, btt.src].contiguous(),  # (J, N, N)
                   idx=a.adj.idx[labs].contiguous(),
                   ts=a.adj.ts[labs].contiguous())
    del svc, group, ex, a
    if on_card:
        torch.cuda.empty_cache()
    return out


def b6_operands(torch, gen, m: int, c: int, e: int, keys: str = "random"):
    """Random slot rows on the card: keys in [0, E) ("random") or within two
    columns of a 4096-column tile edge ("boundary"), a quarter of the slots
    free (-inf, stale keys), duplicate keys in odd slots, every third row
    all free; every slot free with ``keys="free"``."""
    idx = torch.randint(0, e, (m, c), generator=gen, device="cuda",
                        dtype=torch.int32)
    if keys == "boundary":
        near = (torch.arange(4096, e, 4096, device="cuda")[:, None]
                + torch.arange(-2, 2, device="cuda")[None]).reshape(-1)
        near = near[(near >= 0) & (near < e)].to(torch.int32)
        idx = near[torch.randint(0, near.numel(), (m, c), generator=gen,
                                 device="cuda")]
    if c > 1:
        idx[:, 1::2] = idx[:, 0:1]
    ts = torch.rand((m, c), generator=gen, device="cuda") * 1000.0
    ts[torch.rand((m, c), generator=gen, device="cuda") < 0.25] = float("-inf")
    ts[::3] = float("-inf")
    if keys == "free":
        ts[:] = float("-inf")
    return idx, ts


def b6_at_path_shapes(torch, gen, rs, check_b6):
    """Phase 9: B6 against its plain version and timed on phase 8's final
    slot rows (Q*F, C) and at a synthetic M=4096, C=64, E=32768: device
    time (``graph_ms``) beside the bound and the one-call PyTorch
    yardstick's device time (its fill and scatter kernels), the CUDA-event
    time per call with the host's enqueue included, the wrapper's host time
    per call, and the plain version. Frees the operands."""
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.kernels.rowsparse.ref import rowsparse_gather_ref

    e = rs.pop("e")
    path = (rs.pop("sid"), rs.pop("sts"))
    rows = {}
    for tag, (idx, ts), reps in (("path", path, 50),
                                 ("synthetic", b6_operands(torch, gen, 4096, 64,
                                                           32768), 20)):
        m, c = idx.shape
        check_b6(idx, ts, e, f"the {tag} shape M={m} C={c} E={e}")
        idx_l = idx.long()

        def yardstick():
            out = torch.full((m, e), float("-inf"), device=ts.device)
            return out.scatter_reduce_(1, idx_l, ts, "amax", include_self=True)

        if not torch.equal(yardstick(), b6.rowsparse_gather(idx, ts, e)):
            fail(f"the yardstick differs from B6 at the {tag} shape")
        torch.cuda.synchronize()
        def kernel():
            return b6.rowsparse_gather(idx, ts, e)

        ms, ms_each = graph_ms(torch, kernel, reps)
        lib, lib_each = graph_ms(torch, yardstick, reps)
        ms_call = time_cuda(torch, kernel, reps)
        lib_call = time_cuda(torch, yardstick, reps)
        host = host_us(torch, kernel, reps)
        plain = time_cuda(torch, lambda: rowsparse_gather_ref(idx, ts, e),
                          max(1, reps // 5))
        live = int((ts > float("-inf")).sum())
        bms, by = bound_b6_ms(m, c, e, live)
        rows[tag] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by, "shape": [m, c, e],
                     "ms_graph_replays": ms_each, "library_ms_graph_replays": lib_each,
                     "ms_per_call_with_enqueue": ms_call,
                     "library_ms_per_call_with_enqueue": lib_call,
                     "host_us_per_call": host}
        print(f"[kernel] B6 {tag} shape M={m} C={c} E={e} ({live} live slots): "
              f"device {ms:.4f} ms, bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% "
              f"of bound; yardstick device {lib:.4f} ms (fill + scatter), both the "
              f"median of 3 replays of a CUDA graph of {reps} calls "
              f"({[round(x, 4) for x in ms_each]}, {[round(x, 4) for x in lib_each]}); "
              f"per call, "
              f"host enqueue included: {ms_call:.4f} ms, yardstick {lib_call:.4f} "
              f"ms; wrapper host {host:.1f} us per call; plain {plain:.3f} ms",
              flush=True)
        del idx, ts, idx_l
    del path
    torch.cuda.empty_cache()
    return rows


def b5_at_path_shapes(torch, ell, check_b5):
    """Phase 7: B5 against its plain version and timed at the frontier's
    (J, F, N, E) (the F rows of each transition's slab with the most
    finite entries) and the dense round's (J, N, N, E), on phase 6's final
    operands, beside the bound, the plain version and the two-call PyTorch
    yardstick. Frees the operands."""
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.ell.ref import ell_gather_contract_ref

    d, idx, ts = ell.pop("d"), ell.pop("idx"), ell.pop("ts")
    j, n, _ = d.shape
    e = idx.shape[2]
    f = ell["frontier_cap"]
    live = (d > float("-inf")).sum(dim=2)                     # (J, N)
    top = torch.topk(live, f, dim=1).indices                  # (J, F)
    d_f = d.gather(1, top[:, :, None].expand(j, f, n)).contiguous()
    idx_l = idx.long().reshape(j, 1, n * e)

    def yardstick(dd):
        cand = torch.minimum(dd[:, :, :, None], ts[:, None])          # call 1
        out = torch.full(dd.shape, float("-inf"), device=dd.device)
        return out.scatter_reduce_(2, idx_l.expand(-1, dd.shape[1], -1),  # call 2
                                   cand.reshape(j, dd.shape[1], n * e),
                                   "amax", include_self=True)

    rows = {}
    # phase 11's B5-int32 operands: the frontier shape's, encoded to levels
    # on the grid of the run's latest timestamp and the 20 s window
    from repro_torch.core.contraction import BucketBackend
    clock = ts.max()
    enc = BucketBackend(BUCKET_LEVELS)
    rows["s32_operands"] = (enc.encode(d_f, clock, 20.0), idx,
                            enc.encode(ts, clock, 20.0))
    for tag, dd, reps in (("frontier", d_f, 20), ("dense", d, 3)):
        m = dd.shape[1]
        check_b5(dd, idx, ts, f"{tag} shape J={j} M={m} U={n} E={e}")
        if not torch.equal(yardstick(dd), b5.ell_gather_contract(dd, idx, ts)):
            fail(f"the two-call yardstick differs from B5 at the {tag} shape")
        torch.cuda.synchronize()
        ms = time_cuda(torch, lambda: b5.ell_gather_contract(dd, idx, ts), reps)
        plain = time_cuda(torch, lambda: ell_gather_contract_ref(dd, idx, ts),
                          max(1, reps // 3))
        lib = time_cuda(torch, lambda: yardstick(dd), max(1, reps // 3))
        cands = int((dd > float("-inf")).sum()) * e
        bms, by = bound_ell_ms(j, m, n, e, cands)
        rows[tag] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by, "shape": [j, m, n, e]}
        print(f"[kernel] B5 {tag} shape J={j} M={m} U={n} E={e} "
              f"({cands} live candidates): {ms:.3f} ms, bound {bms:.3f} ms "
              f"({by}), {100 * bms / ms:.1f}% of bound; plain {plain:.3f} ms; "
              f"two-call yardstick {lib:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    del d, d_f, idx, ts
    torch.cuda.empty_cache()
    return rows


def float_twin(torch, svc, group, queries, timed, tail):
    """A float service's final state, the twin phase 10's bucket run is
    held against: per query its dist, finals mask and currently valid
    pairs (copied to the host, so the bucket run has the card to itself)
    and its reference engine's results; the slot map, the clock, and the
    sgts it was fed (``timed`` in its timed run, then ``tail``)."""
    ex = group.executor
    lanes = [group.lane_of(name) for name in queries]
    dist, valid = ex.dense_dist(), ex.emit(group.tables)
    return {"dist": [dist[lane].to("cpu", copy=True) for lane in lanes],
            "valid": [valid[lane].to("cpu", copy=True) for lane in lanes],
            "finals": [group.finals_mask[lane].to("cpu", copy=True)
                       for lane in lanes],
            "ref": {name: set(svc.results(f"{name}_ref")) for name in queries},
            "slot_of": dict(group.slot_of), "now": ex.arrays.now.cpu(),
            "timed": list(timed), "tail": list(tail)}


def bucket_phase(torch, queries, twin, n_slots: int, tag: str, device=None,
                 **layout):
    """Phase 10: the 11 queries as one dense group with the bucket backend
    (``BucketBackend(n_levels=8)``) in the service configuration of a float
    run (``layout``, ``n_slots``), fed that run's sgts; held against that
    run's final state and reference results (``twin``, from
    ``float_twin``) with the checks listed in the module docstring. With
    ``adj_layout="ell"`` every round runs B5's int32 entry, otherwise B3.
    ``device`` and ``n_slots`` let the same code rehearse on the CPU at a
    small size. Returns the run's counts."""
    from repro_torch.core.contraction import BucketBackend
    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.stream import Stream

    on_card = device is None
    window, slide = 20.0, 2.0
    svc = PersistentQueryService(window=window, slide=slide, device=device,
                                 **layout)
    for name, expr in queries.items():
        svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1,
                     backend=BucketBackend(n_levels=BUCKET_LEVELS))
    bg = svc.queries["Q1"]
    ex = bg.executor
    dev = ex.arrays.now.device
    timed_part, tail = twin["timed"], twin["tail"]
    tuples = timed_part + tail
    n_del = sum(1 for s in tuples if s.op == "-")
    rounds0, steps0 = ex.rounds_total, ex.steps
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    b1.maxmin_matmul_fused.launches = 0
    b3.bucket_maxmin_fused.launches = 0
    b5.ell_gather_contract.launches = 0
    b6.rowsparse_gather.launches = 0
    t0 = time.perf_counter()
    svc.ingest(Stream(timed_part), record_latency=True)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = sorted(svc.stats["Q1"].latencies_us)
    if on_card:
        trace_window(torch, lambda: svc.ingest(Stream(tail)), len(tail),
                     f"{tag}-trace", top=10)
    elif tail:
        svc.ingest(Stream(tail))
    launches = (b3.bucket_maxmin_fused.launches, b1.maxmin_matmul_fused.launches,
                b5.ell_gather_contract.launches, b6.rowsparse_gather.launches)
    rounds = ex.rounds_total - rounds0
    steps = ex.steps - steps0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    J, N, K, Q = bg.btt.qidx.shape[0], bg.n_slots, bg.k, bg.q_cap
    ell = layout.get("adj_layout") == "ell"
    # B6 gathers the raw rows once per frontier insert that did not fall back
    fst = ex.frontier_stats
    b6_expected = ((fst["dispatches"] - fst["delete_dispatches"])
                   - (fst["fallbacks"] - fst["delete_fallbacks"])
                   if layout.get("dist_layout") == "row_sparse" else 0)
    print(f"[{tag}] mxu_bucket, n_levels={BUCKET_LEVELS}, {layout or 'dense'}: "
          f"{Q} lanes, J={J}, K={K}, N={N}; {len(tuples) - n_del} inserts + "
          f"{n_del} deletions = {len(tuples)} sgts; the first {len(timed_part)} "
          f"in {wall:.3f} s = {len(timed_part) / wall:.3f} sgts/s, dispatch p50 "
          f"{lat[len(lat) // 2] / 1e3:.3f} ms, p99 "
          f"{lat[min(int(0.99 * len(lat)), len(lat) - 1)] / 1e3:.3f} ms; all "
          f"{len(tuples)}: {steps} dispatches, {rounds} closure rounds; launches "
          f"B3 {launches[0]}, B1 {launches[1]}, B5{'-int32' if ell else ''} "
          f"{launches[2]}, B6 {launches[3]}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)

    expected = ((0, 0, rounds) if ell else (rounds, 0, 0)) + (b6_expected,)
    if on_card and not (launches == expected and rounds > 0):
        fail(f"{tag} run: launches (B3, B1, B5, B6) {launches} != {expected}")
    missing = [n for n in queries if not twin["ref"][n] <= svc.results(n)]
    if missing:
        fail(f"{tag} results miss reference result pairs for {missing}")
    if bg.slot_of != twin["slot_of"]:
        fail(f"{tag} and its float twin interned the vertices to different slots")
    # at the end: validity, the bottleneck bound and the origin-free guard
    now = twin["now"].to(dev)
    if not torch.equal(now, ex.arrays.now):
        fail(f"{tag} ended at another clock than its float twin")
    w = torch.tensor(window, dtype=torch.float32, device=dev)
    step = w / BUCKET_LEVELS
    origin = torch.floor((now - w) / step) * step
    low = now - w
    vb, dist_b = ex.emit(bg.tables), ex.dense_dist()
    n_extra = n_grid = 0
    for i, name in enumerate(queries):
        lb = bg.lane_of(name)
        vt, dt = twin["valid"][i].to(dev), twin["dist"][i].to(dev)
        if bool((vt & ~vb[lb]).any()):
            fail(f"{name}: a pair valid in the float twin is not valid in the "
                 f"{tag} run")
        fin = twin["finals"][i].to(dev)
        best = dt.masked_fill(~fin[None, None, :], float("-inf")).amax(2)
        extra = best[vb[lb] & ~vt]
        n_extra += extra.numel()
        if bool(((extra < low - step - 1e-4) | (extra > low + 1e-4)).any()):
            fail(f"{name}: an extra {tag} pair's true bottleneck lies more "
                 "than one level step below the threshold")
        db = dist_b[lb]
        dt = dt[..., : db.shape[2]]
        fin_b = torch.isfinite(db)
        expected_d = torch.ceil(dt / step) * step
        if not torch.equal(db[fin_b], expected_d[fin_b]):
            fail(f"{name}: the {tag} dist is not the float twin's dist mapped "
                 "through the level grid")
        if bool((dt[~fin_b] > origin + 1e-4).any()):
            fail(f"{name}: the {tag} run dropped a value above the window origin")
        n_grid += int(fin_b.sum())
        del vt, dt, best, db, fin_b, expected_d
    n_ref = sum(len(twin["ref"][n]) for n in queries)
    n_bucket = sum(len(svc.results(n)) for n in queries)
    print(f"[{tag}] results: reference {n_ref} pairs, all in the bucket run's "
          f"{n_bucket}; at the end {n_extra} extra valid pairs, each within one "
          f"level step ({float(step):.3f} s) below its threshold; {n_grid} "
          f"finite bucket entries == the float twin's grid-mapped dist",
          flush=True)
    out = {"J": J, "launches": launches, "rounds": rounds}
    del svc, bg, ex, vb, dist_b
    if on_card:
        torch.cuda.empty_cache()
    return out


def bound_level_ms(j: int, m: int, k: int, n: int, t_levels: int):
    """(bound in ms, "bytes" | "operations") of one level product: int32
    inputs read once and the int32 output written once, against T boolean
    products of 2*m*k*n int8 operations each on the tensor cores."""
    t_bytes = 4 * (j * m * k + j * k * n + j * m * n) / PEAK_BYTES
    t_ops = 2.0 * j * m * k * n * t_levels / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def level_kernels_phase(torch, gen, j_path: int, n: int, b5_rows):
    """Phase 11: B3, B4, B2 and B5-int32 against their plain versions on the
    test shapes and at the path's shapes, then timed beside the bound, the
    plain version and the library yardstick. Returns the JSON rows' data."""
    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.bucket.ref import bucket_maxmin_fused_ref, bucket_maxmin_ref
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.ell.ref import ell_gather_contract_ref
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.maxmin.ref import maxmin_matmul_ref

    t_lv = BUCKET_LEVELS + 1

    def levels(shape, t):
        return torch.randint(0, t + 1, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    errs = {"B2": 0.0, "B3": 0.0, "B4": 0.0, "B5-int32": 0.0}

    def same(out, ref, what):
        """Fails unless ``out`` equals ``ref``; keeps the largest |out - ref|
        per kernel (the name that starts ``what``) for the JSON line."""
        diff = (out.float() - ref.float()).abs().masked_fill(out == ref, 0.0)
        err = float(diff.max()) if diff.numel() else 0.0
        key = what.split()[0]
        errs[key] = max(errs[key], err)
        if not torch.equal(out, ref):
            fail(f"{what} differs from its plain version: max |err| {err}")

    # test shapes (tests/test_torch_gpu.py: BUCKET_CASES, CASES)
    for (j, m, k, nn, t) in ((1, 16, 16, 16, 4), (1, 128, 128, 128, 8),
                             (1, 70, 200, 90, 3), (1, 1, 130, 257, 6),
                             (1, 1, 7, 5, 1), (3, 33, 70, 9, 9),
                             (3, 4, 2048, 100, 9), (5, 65, 129, 63, 20),
                             (2, 100, 1, 3, 9)):
        a, b = levels((j, m, k), t + 2), levels((j, k, nn), t + 2)
        same(b3.bucket_maxmin_fused(a, b, n_levels=t),
             bucket_maxmin_fused_ref(a, b, t), f"B3 at {(j, m, k, nn, t)}")
        same(b3.bucket_maxmin(a[0].contiguous(), b[0].contiguous(), n_levels=t),
             bucket_maxmin_ref(a[0], b[0], t), f"B4 at {(m, k, nn, t)}")
    for dtype in (torch.float32, torch.float16):
        for (m, k, nn) in SHAPES:
            a = torch.rand((m, k), generator=gen, device="cuda").to(dtype)
            b = torch.rand((k, nn), generator=gen, device="cuda").to(dtype)
            a[: max(1, m // 7)] = float("-inf")
            same(b1.maxmin_matmul(a, b), maxmin_matmul_ref(a, b),
                 f"B2 at {(m, k, nn)} {dtype}")
    for (j, m, u, e) in B5_CASES:
        d, ts = levels((j, m, u), t_lv), levels((j, u, e), t_lv)
        idx = torch.randint(0, u, (j, u, e), generator=gen, device="cuda",
                            dtype=torch.int32)
        same(b5.ell_gather_contract(d, idx, ts),
             ell_gather_contract_ref(d, idx, ts, zero=0), f"B5-int32 at {(j, m, u, e)}")
    print(f"[kernel] B3, B4 == plain (torch.equal) on 9 test shapes, B2 on "
          f"{len(SHAPES)} float32 and float16, B5-int32 on {len(B5_CASES)}",
          flush=True)

    rows = {}
    # B3 at the dense round's (J, N, N, N) and the frontier's skinny slabs
    a, b = levels((j_path, n, n), t_lv), levels((j_path, n, n), t_lv)
    for m in SKINNY_M:
        am = a[:, :m].contiguous()
        same(b3.bucket_maxmin_fused(am, b, n_levels=t_lv),
             bucket_maxmin_fused_ref(am, b, t_lv), f"B3 at J={j_path} m={m} N={n}")
    out = b3.bucket_maxmin_fused(a, b, n_levels=t_lv)
    same(out, bucket_maxmin_fused_ref(a, b, t_lv), f"B3 at J={j_path} N={n}")

    def bmm_yardstick(x, y):
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=torch.int32,
                          device=x.device)
        for theta in range(1, t_lv + 1):
            acc += (torch.matmul((x >= theta).to(torch.bfloat16),
                                 (y >= theta).to(torch.bfloat16)) > 0.5).to(torch.int32)
        return acc

    if not torch.equal(bmm_yardstick(a, b), out):
        fail("the bmm yardstick differs from B3")
    del out
    rows["B3"] = timed(torch, lambda: b3.bucket_maxmin_fused(a, b, n_levels=t_lv),
                       lambda: bucket_maxmin_fused_ref(a, b, t_lv),
                       lambda: bmm_yardstick(a, b), 10, 2,
                       bound_level_ms(j_path, n, n, n, t_lv),
                       [j_path, n, n, n, t_lv], "B3")
    a1, b1_ = a[0].contiguous(), b[0].contiguous()
    del a, b
    torch.cuda.empty_cache()
    same(b3.bucket_maxmin(a1, b1_, n_levels=t_lv), bucket_maxmin_ref(a1, b1_, t_lv),
         f"B4 at {n}^3")
    rows["B4"] = timed(torch, lambda: b3.bucket_maxmin(a1, b1_, n_levels=t_lv),
                       lambda: bucket_maxmin_ref(a1, b1_, t_lv),
                       lambda: bmm_yardstick(a1, b1_), 20, 5,
                       bound_level_ms(1, n, n, n, t_lv), [n, n, n, t_lv], "B4")
    # B2 at (N, N) x (N, N) float32
    x = torch.rand((n, n), generator=gen, device="cuda") * 1000.0
    y = torch.rand((n, n), generator=gen, device="cuda") * 1000.0
    x[torch.rand((n, n), generator=gen, device="cuda") > 0.7] = float("-inf")
    same(b1.maxmin_matmul(x, y), maxmin_matmul_ref(x, y), f"B2 at {n}^3")
    rows["B2"] = timed(torch, lambda: b1.maxmin_matmul(x, y),
                       lambda: maxmin_matmul_ref(x, y), None, 10, 1,
                       bound_ms(1, n, n, n), [n, n, n], "B2")
    # B5-int32 at phase 6's frontier shape, on its operands encoded to levels
    d, idx, ts = b5_rows.pop("s32_operands")
    j, m, u = d.shape
    e = idx.shape[2]
    same(b5.ell_gather_contract(d, idx, ts),
         ell_gather_contract_ref(d, idx, ts, zero=0), f"B5-int32 at {(j, m, u, e)}")
    idx_l = idx.long().reshape(j, 1, u * e)

    def ell_yardstick():
        cand = torch.minimum(d[:, :, :, None], ts[:, None])           # call 1
        o = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
        return o.scatter_reduce_(2, idx_l.expand(-1, m, -1),           # call 2
                                 cand.reshape(j, m, u * e), "amax", include_self=True)

    if not torch.equal(ell_yardstick(), b5.ell_gather_contract(d, idx, ts)):
        fail("the two-call yardstick differs from B5-int32")
    cands = int((d > 0).sum()) * e
    t_bytes = (4 * 2 * j * m * u + 8 * j * u * e) / PEAK_BYTES
    t_ops = 2.0 * cands / PEAK_F32_OPS
    rows["B5-int32"] = timed(
        torch, lambda: b5.ell_gather_contract(d, idx, ts),
        lambda: ell_gather_contract_ref(d, idx, ts, zero=0), ell_yardstick, 20, 5,
        (max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"),
        [j, m, u, e], "B5-int32")
    del d, idx, ts, x, y, a1, b1_
    torch.cuda.empty_cache()
    for key, err in errs.items():
        rows[key]["max_abs_err"] = err
    return rows


def timed(torch, kernel, plain, library, reps: int, plain_reps: int, bound,
          shape, tag: str):
    """CUDA-event times of a kernel, its plain version and its library
    yardstick (None: no PyTorch call computes it), printed beside the
    bound; returns the JSON row's numbers."""
    ms = time_cuda(torch, kernel, reps)
    plain_ms = time_cuda(torch, plain, plain_reps)
    lib_ms = time_cuda(torch, library, max(1, reps // 2)) if library else None
    bms, by = bound
    print(f"[kernel] {tag} at {shape}: {ms:.3f} ms, bound {bms:.3f} ms ({by}), "
          f"{100 * bms / ms:.1f}% of bound; plain {plain_ms:.3f} ms; yardstick "
          f"{'%.3f ms' % lib_ms if lib_ms is not None else 'none'}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "shape": shape}


def legacy_phase(torch, expr: str, legacy_in, device=None):
    """Phase 12: the legacy single-query closure over phase 4's final
    adjacency for one query (``expr``, Q1's) from -inf: the "cuda" backend
    (B2) against "plain", the bucket backend (B4) against its plain
    versions, launches per transition per round, the grid guard between
    the two, and ``valid_pairs`` at phase 4's clock against phase 4's
    engine. ``device`` lets it rehearse on the CPU. Returns the counts."""
    from repro_torch.core.automaton import compile_query
    from repro_torch.core.contraction import BucketBackend
    from repro_torch.core.semiring import TransitionTable, closure, valid_pairs
    from repro_torch.kernels.bucket import bucket as b4
    from repro_torch.kernels.maxmin import maxmin as b2

    on_card = device is None
    dfa = compile_query(expr)
    tt = TransitionTable.from_dfa(dfa, device=device)
    labels = legacy_in["labels"]
    adj = legacy_in["adj"][[labels.index(lab) for lab in dfa.labels]]
    n = adj.shape[1]
    n_trans = tt.src.shape[0]
    dist0 = torch.full((n, n, dfa.k), float("-inf"), device=adj.device)
    out = {}
    b2.maxmin_matmul.launches = 0
    b4.bucket_maxmin.launches = 0
    t0 = time.perf_counter()
    d_f, rounds = closure(dist0, adj, tt, "cuda")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["b2_launches"] = b2.maxmin_matmul.launches
    d_p, rounds_p = closure(dist0, adj, tt, "plain")
    if not (torch.equal(d_f, d_p) and rounds == rounds_p):
        fail("the legacy closure with B2 differs from the plain one")
    if on_card and out["b2_launches"] != n_trans * rounds:
        fail(f"B2 launches {out['b2_launches']} != {n_trans} transitions x "
             f"{rounds} rounds")
    finals = torch.tensor([s in dfa.finals for s in range(dfa.k)], device=adj.device)
    now = legacy_in["now"]
    w = torch.tensor(legacy_in["window"], dtype=torch.float32, device=now.device)
    valid = valid_pairs(d_f, finals, now - w)
    if not torch.equal(valid, legacy_in["valid"]):
        fail("valid_pairs of the legacy closure differ from the dense engine's "
             "valid pairs for Q1")
    bucket = BucketBackend(BUCKET_LEVELS)
    d_l, a_l = bucket.prepare_state(dist0, adj, now, w)
    t1 = time.perf_counter()
    o_l, rounds_l = closure(d_l, a_l, tt, bucket)
    if on_card:
        torch.cuda.synchronize()
    wall_l = time.perf_counter() - t1
    out["b4_launches"] = b4.bucket_maxmin.launches
    o_p, rounds_lp = closure(d_l, a_l, tt, BucketBackend(BUCKET_LEVELS,
                                                         use_kernels=False))
    if not (torch.equal(o_l, o_p) and rounds_l == rounds_lp):
        fail("the legacy closure with B4 differs from the plain bucket one")
    if on_card and out["b4_launches"] != n_trans * rounds_l:
        fail(f"B4 launches {out['b4_launches']} != {n_trans} transitions x "
             f"{rounds_l} rounds")
    dec = bucket.decode_state(o_l, now, w)
    step = w / BUCKET_LEVELS
    origin = torch.floor((now - w) / step) * step
    fin = torch.isfinite(dec)
    if not torch.equal(dec[fin], (torch.ceil(d_f / step) * step)[fin]) or \
            bool((d_f[~fin] > origin + 1e-4).any()):
        fail("the legacy bucket closure is not the float closure mapped "
             "through the level grid")
    print(f"[legacy] {expr} (K={dfa.k}, {n_trans} transitions) over phase 4's "
          f"final adjacency at N={n}: float closure {rounds} rounds in "
          f"{wall:.3f} s == plain, B2 launches {out['b2_launches']}; valid_pairs "
          f"== the engine's {int(valid.sum())} valid pairs; bucket closure "
          f"{rounds_l} rounds in {wall_l:.3f} s == plain, B4 launches "
          f"{out['b4_launches']}; decoded == the grid-mapped float closure",
          flush=True)
    return out


if __name__ == "__main__":
    main()
