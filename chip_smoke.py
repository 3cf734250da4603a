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
   whole kernel tiles are -inf, which its occupancy pre-pass lets it skip;
   B5 through both entries: on pre-gathered rows, and whole, on ELL
   leaves of 3 labels with int32 and int64 labels and a full 64-entry
   ring with out-of-range entries, also at U beyond one block's shared
   memory, one launch a call),
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
   launched exactly as often as the executor's ELL contractions (one per
   frontier round, one per J chunk of a dense round) and B1 and B5's
   gather-contract entry never, that the frontier ran and also fell back
   (dispatches > fallbacks >= 1), that a delete went through the cone, and that the
   spill ring drained and re-packed.
7. B5 at the path's shapes: on this run's final operands (the gathered
   dist rows, the ELL adjacency's own leaves and ring, the transition
   labels), both entries ``torch.equal`` to their plain versions at the
   frontier's (J, F, 8192, E) and the dense round's (J, 8192, 8192, E);
   the whole entry's device time (CUDA-graph replay at the frontier's
   shape), its time per call with the host's enqueue and the wrapper's
   host time beside the recounted bound, the plain version, the PyTorch
   yardstick (``torch.minimum`` of the slot candidates, a
   ``scatter_reduce_(..., "amax")``, then the same for the ring's), which
   the port never calls, the whole ``contract_rows_ell`` call and the
   gather-contract entry; the same on the int32 entry at the dense
   round's shape.
8. end to end, row-sparse dist: phase 6's service and stream again with
   ``dist_layout="row_sparse", dist_cap=4`` (rows overflow into the
   table, drains grow and re-pack). Asserts every query's per-event result
   log equals phase 6's and the reference engine's, the same
   frontier dispatches and fallbacks as phase 6 (at least one: the densify
   round trip runs), at least one drain and one re-pack with nothing lost,
   B6 launched once per frontier insert dispatch that did not fall back,
   B5 as often as the executor's ELL contractions and B1 never; the
   device operations a dispatch in its traced window.
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
   ELL adjacency and row-sparse dist B5's int32 entry ran once per
   frontier round and once per J chunk of a dense round (the executor's
   ELL contractions) and B6 once per frontier insert that did not fall
   back (B1 and B3 never). Each
   run's last window (the twin's traced sgts) runs under
   ``torch.profiler``: its top device kernels. After the dense run, B3 on
   that run's own last-round level operands (the final dist gathered per
   transition row and the adjacency rows of their labels, encoded on the
   run's grid): ``torch.equal`` against the plain version and the
   yardstick, the share of a's and b's pre-pass tiles above level 0 and of
   the (warp, k tile, threshold) steps the product runs (from bucket.cu's
   measurement-only counting entry), and CUDA-event times beside the bound
   counted from what those inputs need, the plain version and the
   yardstick.
11. B3, B4, B2 and B5 on int32 levels against their plain versions
   (``torch.equal``) on the test shapes, on B3's level patterns
   (``tests/_torch_levels.py``: whole pre-pass tiles at level 0, corner
   entries, the worst case, the clamp; T in {0, 1, 9, 127}) at ragged,
   skinny and long-k shapes, and at the path's shapes (B3 at (J, 2048,
   2048, 2048, T=9) and at the frontier's m in {4, 32}; B2 and B4 at
   2048^3; B5-int32 through both entries, the whole one also with a full
   ring and at U beyond one block's shared memory, and at phase 6's
   frontier shape, on phase 6's operands and ELL adjacency encoded to
   levels, where it is timed like phase 7); CUDA-event times beside the
   bound (the larger of bytes over 3.35 TB/s and, for B3/B4, the int8 operations the data
   needs, 2 per (j, i, k, n, theta) with both levels >= theta, over 1979
   TOP/s), the plain version and the library yardstick (T
   ``torch.bmm`` calls on bf16 0/1 operands, then the compare and sum),
   which the port never calls: B3 on uniform levels and on the worst case
   (a at T, b at T but for one level-0 column in every 32, so every
   threshold of every k tile runs), each with the share of steps run.
12. the legacy single-query round: phase 4's final dense adjacency and
   Q1's DFA at n_slots=2048. ``closure`` from -inf with the "cuda"
   backend (B2) is ``torch.equal`` to "plain", with B2 launched once per
   transition per round; the same with ``BucketBackend`` (B4) on encoded
   levels against its plain versions, whose decoded result is the float
   closure mapped through the grid; ``valid_pairs`` at phase 4's clock
   equals phase 4's dense engine's valid pairs for Q1.
13. the supervised service (``ServiceSupervisor``: write-ahead log,
   async snapshots every 8 batches of 8 sgts, crash -> restore -> WAL
   replay with ``verify_replay``) over phase 4's configuration and the
   first 512 inserts of its stream, the three Q3 conflict edges placed
   after the chaos run's last committed snapshot. A clean run, then a
   chaos run that crashes before dispatch, during the replay, after
   dispatch (of the last batch, after Q3's fallback), mid-snapshot at
   each of ``shards``, ``manifest`` and ``rename`` (the last one after
   the fallback), and raises one transient error. Asserts the chaos run's
   result and invalidation streams and final results equal the clean
   run's, every fault fired, Q3's simple lane ended on the host RSPQ in
   both, every restore left each executor tensor on the card, and B1 ran
   once per closure round of every service the runs built. Then the
   breaker leg: phase 8's sparse configuration at n_slots=2048 on
   ``so_like(n_vertices=2048, rate=50)``, clean and under a
   ``CircuitBreaker`` that trips to the dense fallbacks at any overflow
   and re-arms after one quiet interval: equal final results, and B5, B6
   (sparse services) and B1 (dense ones) as often as the services'
   counters say. Prints per snapshot the seconds the caller blocks, the
   background write's seconds and bytes; per recovery ``recovery_s``, the
   replayed events, ``replay_eps``, and the restore split into the npz
   read and ``adopt_state``/placement; the WAL's append + fsync per batch;
   sgts/s beside phase 4's; each line with ``nvidia-smi``'s name and power
   limit. The checkpoint directories live under ``build/`` and are removed.
14. the mesh executor (``MeshExecutor``, one process, four shards over
   the visible cards in turn: ``["cuda:0"] * 4`` on one card) through the service in phase 4's configuration
   (the 11 queries and the simple lanes of Q2 and Q3, no reference
   engines), four legs: (a) lanes (4x1 grid) on phase 4's whole stream:
   every query's results, per-event result logs and per-event deletion
   invalidations equal phase 4's, Q3's simple lane falls back at the same
   stream time with the same log, and the sync rounds equal phase 4's
   closure rounds; (b) vertices (2x2: two lane shards, each over two model
   peers that fold their partials with max) and (c) the sparse layouts
   (2x2, ``frontier="auto"``, ELL, row-sparse: each lane shard's slab
   densified per dispatch, so cut to n_slots=2048 from phase 8's 8192; also
   against a local run of that configuration) on phase 4's first 512
   inserts, against phase 4's log prefix; (d) ``BucketBackend(8)`` on the
   lane grid over that prefix against phase 10's dense bucket run. Each
   leg asserts ``shard_rounds + skipped == n_shards x sync_rounds`` (with
   skipped > 0 on the 4x1 grid; each of the 2x2 grid's two lane shards
   holds a lane that closes over every label, Q4 or Q9, so they may
   converge together), B1 (B3 in (d)) launched exactly n_model x shard_rounds
   times and B5 and B6 never, and prints sgts/s and dispatch p50/p99
   beside phase 4's, the shard-rounds run and skipped, peak device memory
   and ``nvidia-smi``'s name and power limit. The state lies at rest as
   the reference lays it out (each model peer's u-row and v-column
   adjacency blocks, views of one slab on one card; a row-sparse dist's
   slot leaves per lane shard): leg (c)'s configuration runs its first
   ``MESH_SPY_SGTS`` sgts again with every ingest and delete dispatch
   under a spy (tests/_torch_spy.py) that fails if one allocates a whole
   (L, N, N) adjacency or (Q, N, N, K) dist, or moves an adjacency block.
15. the dry run on the card (``repro_torch.launch.dryrun_rpq``): on the
   16x16 production grid, for each of its three cells (n_slots 4096, 8192,
   16384) and the modes baseline, mxu (B3), ring, batched (B1),
   batched-mxu_bucket (B3) and batched-frontier (B1 on (F, N) slabs),
   device (0, 0)'s blocks made from a seeded generator and its share of
   one round run with the kernels: its CUDA-event time, peak memory,
   whether it fits the card, the collective bytes the layout implies per
   round and the bound, one line per record beside ``nvidia-smi``'s name
   and power limit. At n_slots=4096 each share equals the same share run
   with the plain versions on the card (``torch.equal``); B1's and B3's
   counters move by exactly the launches the shares make. The records go
   to ``chiprun_out/dryrun_rpq/``.
16. the host-sync census: phase 4's configuration (the dense default, B1;
   no reference engines) and then phase 8's (frontier + ELL + row-sparse,
   B5 and B6), each on the first 256 insert sgts of that phase's stream
   (cut for time), under ``torch.cuda.set_sync_debug_mode("warn")`` with
   every warning recorded and the mode reset after. Each sync is charged
   to its innermost frame under ``src/repro_torch/`` (``device.py``'s
   frames skipped, so a ``device_get`` counts at its caller). Asserts that
   every site inside a function the port's analyzer reaches from its
   dispatch roots (``repro_torch.analysis``, rule R1) is an R1 finding at
   that line, that the dense run's syncs at the fixpoint loop's line
   equal the growth of the executor's ``host_syncs``, that no kernel
   wrapper syncs, and that B1 (dense) and B5 and B6 (sparse) ran. Prints
   each site's file:line, function, reachability and syncs a dispatch,
   and the total a dispatch of each run; the record goes to
   ``chiprun_out/census/``. Syncs inside the CUDA C entries would not
   show; ``csrc/*.cu`` makes none.
17. the LM serving path (``repro_torch.models``: plain PyTorch, no kernel
   of its own, as the JAX package's is plain ``jnp``). (a) The
   ``reduced()`` variant of each of the ten configs in float32, weights
   from a seeded CPU generator copied to the card: forward, loss, a
   prefill of 18 tokens (``max_len=24``) and 6 teacher-forced decode
   steps on the card and on the CPU, every logit within 1e-4 x (1 +
   |CPU's|), the MoE layers' chosen experts equal. (b) smollm-360m and
   mamba2-370m at full width in float32: the card's forward on (1, 64)
   tokens against the CPU's, and on the card a prefill of 48 tokens + 16
   teacher-forced decode steps against its own forward, within 1e-3 x
   (1 + |ref|). TF32 must be off. (c) bfloat16 serving at full width
   (the configs' own ``param_dtype``, the port's seeded init):
   smollm-360m and mamba2-370m at batch 8, qwen2.5-14b at batch 4, prompt
   2048 and 64 decode steps; dbrx-132b with its depth cut to 2 layers,
   batch 4, prompt 2048, 16 decode steps (capacity factor 1.25: tokens
   drop; kept per expert == min(routed, capacity), the kept share
   printed). Each prints prefill tokens/s beside its bound (the matmul
   and attention FLOPs the prefill needs, ``repro_torch.launch.roofline``'s
   count with the run's kept expert pairs, over 989 TFLOP/s), decode step
   p50/p99 and tokens/s beside its bound (the bytes a step must move:
   weights, the routed experts, live KV rows read and one written, SSM
   and conv states read and written, over 3.35 TB/s), and peak device
   memory; asserts
   finite logits and, but for dbrx (whose capacity differs between a
   decode call and the full forward by design), decode within 0.5 of the
   full forward (absolute; logits reach |6|). (d) One prefill and 8 decode
   steps of the mamba2, qwen2.5 and dbrx runs under phase 16's sync
   census: no sync charged to ``src/repro_torch/models/``. (e) The top
   device kernels of one decode step and one prefill of mamba2-370m and
   qwen2.5-14b under ``torch.profiler``. Each model is freed before the next; the record
   goes to ``chiprun_out/lm/``.
18. LM training (``repro_torch.launch.train``, ``repro_torch.optim``:
   AdamW, the bfloat16 gradient accumulation and the nested remat, plain
   PyTorch, no kernel of their own). (a) Each ``reduced()`` config in
   float32, weights from a seeded CPU generator copied to the card: one
   ``make_train_step`` at ``microbatches`` 1 and one at 2 on (4, 32)
   tokens, from zero moments, on the card and on the CPU: loss, grad
   norm, m and v within 1e-4 x (1 + |CPU's|), the lr within 1e-6
   relative, every parameter within 1e-5 x (1 + |CPU's|) but where the
   step's clipped gradient lies within 1e-4 (x the clip scale) of zero
   (Adam's first update is ~lr * sign(g): such an entry may differ by 2
   lr more; counted). (b) smollm-360m and mamba2-370m at full width in
   float32, one step on (2, 64) tokens, the same check at 1e-3, and the
   card's gradients with remat on against remat off within 1e-3 x (1 +
   |ref|). (c) bfloat16 training at full width with the config's own
   ``opt_state_dtype``, ``microbatches`` and remat and the train CLI's
   ``AdamWConfig`` (lr_peak 3e-3, 10 warm-up steps), the port's seeded
   init and one random batch of 8 x 2048 repeated: smollm-360m and
   mamba2-370m at full depth, qwen2.5-14b cut to 4 of its 48 layers
   (its 8 microbatches); 2 warm-up and 5 timed steps: step p50 and
   tokens/s beside the FLOP bound (roofline's count: 3 x the forward's
   matmul and attention FLOPs, the LM head on every position, no
   recompute, over 989 TFLOP/s),
   the update's CUDA-event time beside its byte bound (params, grads, m
   and v read, params, m and v written, over 3.35 TB/s), peak memory
   (smollm's also for one loss + backward on 1 x 2048 with remat on and
   off); asserts a finite loss that falls below 0.9 x the first step's
   within the run (at qwen's width the warm-up to lr 3e-3 overshoots after
   memorizing the batch, as the JAX reference does). (d) dbrx-132b cut to 1 of its
   40 layers: the gradients accumulated over its 8 microbatches of a
   batch of 8 x 2048, the clip and the grad norm, without the update
   (its float32 moments would not fit beside them); time, peak, the MoE
   kept share, every gradient finite. (e) Two train steps of the qwen run
   under phase 16's sync census: no sync charged to
   ``src/repro_torch/{models,optim}/`` or ``launch/train.py``. (f) The top
   device kernels of one qwen train step. The record goes to
   ``chiprun_out/lm/phase18.json``.
19. the LM dry run (``repro_torch.launch.dryrun``, ``repro_torch.
   distributed.sharding``: plain PyTorch, no kernel of their own), device
   (0, 0)'s share of each LM cell on the 16x16 grid. (a) One reduced
   config a family (qwen2.5-14b, dbrx-132b, mamba2-370m, jamba, paligemma,
   musicgen) on a 2x2 grid, float32, TF32 off, from the same seeded
   weights: the share's outputs (logits and caches; loss and gradients in
   train) on the card against the CPU's for train, prefill, decode and the
   sequence-sharded decode, within 1e-4 x (1 + max |CPU's|). (b) Every one
   of the 32 cells (10 configs x train_4k, prefill_32k, decode_32k;
   long_500k for mamba2-370m and jamba) and qwen2.5-14b decode_32k with
   serving sharding: the device's at-rest state at real size, its share
   at 1 and 2 periods timed after a warm-up call of each (CUDA-graph
   replays where a period's warm-up takes under 500 ms, the host's
   enqueue pacing much of it; else eager) and extrapolated, the AdamW update of its
   blocks (train), every output and gradient finite; one line a record
   with its bound (what the share needs: roofline's count), state, peak,
   fit, collective bytes and ``nvidia-smi``'s name and power limit. (c)
   smollm-360m's decode_32k and train_4k (timed by replay) and
   qwen2.5-14b's prefill_32k (timed eagerly on purpose) also at full
   depth, within 10% of the extrapolation. (d) One period's share of three cells under
   phase 16's sync census: no sync charged to ``launch/dryrun.py`` or
   ``distributed/sharding.py``. The records go to ``chiprun_out/dryrun/``
   (``phase19.json`` beside the cells').
20. live query churn (benchmarks/fig13_query_churn.py's protocol) through
   the service in phase 4's configuration and on phase 4's stream, cut at
   its thirds: at 1/3 three Table-2 queries under new names (Q4, Q6, Q9)
   and a simple-path lane of Q2's conflict-free DFA register, growing
   ``q_cap`` 13 -> 16 -> 20 and re-padding the (Q, 2048, 2048, 4) dist; at
   2/3 Q5 and Q10 (and their reference engines) retire and Q7 registers
   under a new name into the first freed lane. Each late lane's oracle is
   ``repro_torch.core.engine.make_churn_oracle`` built on the card just
   before its registration. Asserts every surviving query's results,
   per-event result log and deletion invalidations, and Q3's simple
   fallback (time and log), equal phase 4's; each registration's initial
   answers equal its oracle's seed, and each late lane's per-event result
   log, invalidations and results equal its oracle's, fed the rest of the
   stream one sgt at a time and expired at the service's slide
   boundaries; the reclaimed lane is the freed one; B1 launched once per
   closure round of the churned group (its ingests and seeding closures;
   the oracles' launches apart). Prints each registration's host-clock ms
   (re-pad + seeding closure, synchronised), the churned run's sgts/s
   beside phase 4's and peak device memory across the growth, with
   ``nvidia-smi``'s name and power limit. Then runs ``main([])`` of
   examples/{quickstart,streaming_service,distributed_rpq}_torch.py on
   the card.

The last three lines of standard output are the kernels JSON line, the
``nvidia-smi`` name/power-limit line, and the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
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
# tests/test_torch_gpu.py: B5_WIDE, a row wider than one block's shared
# memory (the kernel splits its columns), aligned and ragged
B5_WIDE = [(1, 2, 70000, 3), (1, 2, 70001, 2)]
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
# tests/test_torch_gpu.py: B3_SHAPES (J, m, k, n) for B3/B4's level patterns
B3_SHAPES = [(2, 300, 260, 270), (1, 64, 128, 128), (3, 4, 1000, 300),
             (2, 32, 1000, 512), (2, 257, 49, 131), (1, 130, 70, 30),
             (1, 40, 8325, 70)]
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
SUPERVISED_INSERTS = 512  # phase 13: the first inserts of phase 4's stream
SUPERVISED_BATCH = 8      # phase 13: sgts a WAL record (a supervisor batch)
SUPERVISED_CKPT_EVERY = 8  # phase 13: batches between snapshots (<= 8 of them)
BREAKER_INSERTS = 512     # phase 13's breaker leg
BREAKER_HEALTH_EVERY = 8  # batches a health interval in the breaker leg
MESH_DEVICES = 4          # phase 14: shards over ["cuda:0"] * 4
MESH_PREFIX_INSERTS = 512  # phase 14's legs (b)-(d): phase 4's first inserts
MESH_SPY_SGTS = 96        # phase 14 (c): sgts run again under the dispatch spy
DRYRUN_MODES = ("baseline", "mxu", "ring", "batched", "batched-mxu_bucket",
                "batched-frontier")   # phase 15, on the 16x16 grid
DRYRUN_REPEATS = 3        # phase 15: timed shares after the warm-up
CENSUS_INSERTS = 256      # phase 16: the first insert sgts of phases 4's and 8's streams
SYNC_WARNING = "called a synchronizing CUDA operation"   # sync debug mode's text
# phase 20, live query churn on phase 4's configuration (13 lanes): at 1/3
# of the stream three Table-2 queries under new names and one simple-path
# lane of a conflict-free DFA register, growing q_cap to the next multiple
# of 4 when no lane is free (13 -> 16 at the first, 16 -> 20 at the fourth);
# at 2/3 two founding queries (and their reference twins) retire and one
# more query registers into the first freed lane
CHURN_LATE = {"late_Q4": ("Q4", "arbitrary"), "late_Q6": ("Q6", "arbitrary"),
              "late_Q9": ("Q9", "arbitrary"), "late_Q2_simple": ("Q2", "simple")}
CHURN_Q_CAPS = (13, 16, 16, 16, 20)   # q_cap before and after each late registration
CHURN_RETIRE = ("Q5", "Q10")
CHURN_RECLAIM = ("late_Q7", "Q7")
# phase 17, the LM serving path
LM_REDUCED = dict(prompt=18, max_len=24, decode=6)    # (a) every reduced config
LM_F32_ARCHS = ("smollm-360m", "mamba2-370m")           # (b) full width, float32
LM_F32 = dict(tokens=64, prompt=48, decode=16)
# (c) full width, bfloat16: (arch, batch, prompt, decode steps, layers or None)
LM_SERVE_RUNS = (("smollm-360m", 8, 2048, 64, None), ("mamba2-370m", 8, 2048, 64, None),
                 ("qwen2.5-14b", 4, 2048, 64, None), ("dbrx-132b", 4, 2048, 16, 2))
LM_CENSUS_ARCHS = ("mamba2-370m", "qwen2.5-14b", "dbrx-132b")   # (d)
LM_CENSUS_DECODE = 8
LM_TRACE_ARCHS = ("mamba2-370m", "qwen2.5-14b")                   # (e)
LM_TOL_F32 = 1e-4         # (a): card vs CPU, |a - b| <= tol * (1 + |b|)
LM_TOL_F32_FULL = 1e-3    # (b): card vs CPU, and decode vs the full forward
# (c): decode vs the full forward in bfloat16, absolute. The two paths
# round differently through 24-48 layers (measured 0.099-0.211 at logits of
# max |6|); a misplaced position or cache row moves logits by O(|logit|)
LM_TOL_BF16 = 0.5
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bfloat16 (published)
# phase 18, LM training
LM_TRAIN_OPT = dict(lr_peak=3e-3, warmup_steps=10)   # the train CLI's AdamWConfig
LM_TRAIN_STEPS = 10       # total_steps of (a) and (b)'s schedule
LM_TRAIN_REDUCED = (4, 32)   # (a) batch, tokens
LM_TRAIN_F32 = (2, 64)       # (b) batch, tokens
# (c) full width, bfloat16: (arch, batch, tokens, layers or None)
LM_TRAIN_RUNS = (("smollm-360m", 8, 2048, None), ("mamba2-370m", 8, 2048, None),
                 ("qwen2.5-14b", 8, 2048, 4))
LM_TRAIN_WARMUP, LM_TRAIN_TIMED = 2, 5
LM_TRAIN_FALL = 0.9       # (c): some step's loss below 0.9 x the first step's
LM_TRAIN_UPDATE_REPS = 3
LM_TRAIN_REMAT_ARCH, LM_TRAIN_REMAT_BATCH = "smollm-360m", 1   # (c) peak, remat on / off
LM_TRAIN_CENSUS_ARCH, LM_TRAIN_CENSUS_STEPS = "qwen2.5-14b", 2  # (e), (f)
LM_TRAIN_GRADS = ("dbrx-132b", 8, 2048, 1)                     # (d)
# Adam's first update is ~lr * sign(g): a parameter whose gradient lies
# within LM_TRAIN_EPS_G of zero may differ by 2 lr; every other parameter
# within LM_TRAIN_TOL_PARAM x (1 + |ref|)
LM_TRAIN_EPS_G = 1e-4
LM_TRAIN_TOL_PARAM = 1e-5
# phase 19, the LM dry run on the 16x16 grid
LM_DRY_SERVING = (("qwen2.5-14b", "decode_32k"),)   # also with --serving-sharding
# (c) at full depth: two shares timed by CUDA-graph replay, and one timed
# eagerly although it would be replayed (LM_DRY_EAGER), to hold that method
# to full depth as well: the cells that are eager by GRAPH_MS (dbrx and
# jamba train, jamba prefill) cost 1-3 min a call at full depth, or do not
# fit (jamba's gathered weights alone are ~50 GB at full depth)
LM_DRY_FULL = (("smollm-360m", "decode_32k"), ("smollm-360m", "train_4k"),
               ("qwen2.5-14b", "prefill_32k"))
LM_DRY_EAGER = (("qwen2.5-14b", "prefill_32k"),)
LM_DRY_FULL_TOL = 0.10    # (c): full depth within 10% of the extrapolation
LM_DRY_REPEATS = 2        # timed batches of each share, the median kept
# cut for phase 19's time: one timed batch (one call a depth, after its
# warm-up) of the longest share, ~9 and ~17 s a call
LM_DRY_ONE_BATCH = (("jamba-1.5-large-398b", "train_4k"),)
# (a) one reduced config a family on the 2x2 grid, card against CPU
LM_DRY_FAMILIES = ("qwen2.5-14b", "dbrx-132b", "mamba2-370m", "jamba-1.5-large-398b",
                   "paligemma-3b", "musicgen-large")
LM_DRY_SMALL = ((16, 4, "train"), (16, 4, "prefill"), (16, 4, "decode"), (16, 1, "decode"))
LM_DRY_TOL = 1e-4         # (a): max |card - CPU| <= tol x (1 + max |CPU|), float32
# (d) one period's share under the sync census
LM_DRY_CENSUS = (("smollm-360m", "train_4k"), ("dbrx-132b", "decode_32k"),
                 ("jamba-1.5-large-398b", "long_500k"))


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


def bound_ell_ms(j: int, m: int, u: int, e: int, live_candidates: int,
                 n_labels: int, ring: int):
    """(bound in ms, "bytes" | "operations") of one ELL contraction with
    the label gather and the ring folded in: d (J, M, U) read and the
    (J, M, U) output written once, the (L, U, E) ELL leaves (int32 index,
    4-byte timestamp) and the ring's four (S,) leaves read once, against
    one min and one max per candidate that this run's data holds (finite
    d entries times E slots)."""
    t_bytes = (4 * 2 * j * m * u + 8 * n_labels * u * e + 16 * ring) / PEAK_BYTES
    t_ops = 2.0 * live_candidates / PEAK_F32_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def b5_rows_operands(torch, gen, j: int, m: int, u: int, e: int, levels: bool = False):
    """Random operands of B5's whole entry on the card: d (J, M, U) with 40%
    live entries, ELL leaves of 3 labels (duplicate destinations, all-free
    rows), int32 labels that repeat, and a 64-entry ring whose every entry
    is live: on all labels, one a copy of a row edge, two with dst outside
    [0, U) and one with src outside it (dropped). ``levels``: int32 levels
    1..10 with level 0 for -inf."""
    n_labels, s = 3, 64

    def ts_of(shape, density):
        x = torch.rand(shape, generator=gen, device="cuda") * 1000.0
        x[torch.rand(shape, generator=gen, device="cuda") > density] = float("-inf")
        if levels:
            x = torch.where(x > float("-inf"), x / 100.0 + 1.0, 0.0).to(torch.int32)
        return x

    d = ts_of((j, m, u), 0.4)
    idx = torch.randint(0, u, (n_labels, u, e), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[:, :, 0] = idx[:, :, -1]                  # duplicate destinations
    ts = ts_of((n_labels, u, e), 0.6)
    ts[:, : max(1, u // 7)] = 0 if levels else float("-inf")   # all-free rows
    labs = torch.randint(0, n_labels, (j,), generator=gen, device="cuda",
                         dtype=torch.int32)
    src, dst = (torch.randint(0, u, (s,), generator=gen, device="cuda",
                              dtype=torch.int32) for _ in range(2))
    lab = torch.arange(s, device="cuda", dtype=torch.int32) % n_labels
    sts = ts_of((s,), 1.0)
    src[0], dst[0], lab[0] = 0, idx[0, 0, 0], 0   # a ring copy of a row edge
    dst[1], dst[2], src[3] = u, u + 9, u          # outside [0, U): dropped
    return d, idx, ts, labs, (src, dst, lab, sts)


def trace_window(torch, run, n_sgts: int, tag: str, top: int = 6, unit: str = "sgts") -> int:
    """Run ``run()`` under ``torch.profiler`` (device activity only:
    recording every CPU-side op of the host loop tripled the window's wall
    time) and print the top device kernels by self device time, with the
    window's total device time and wall time. Returns the number of device
    operations (kernels, copies, fills) the window ran."""
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
    n_ops = sum(ev.count for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    print(f"[{tag}] top device kernels over {n_sgts} traced {unit}"
          f"{'' if by_name else ': the profiler recorded no device time'}; "
          f"device time {total:.3f} ms in {wall * 1e3:.3f} ms traced wall",
          flush=True)
    for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[{tag}]   {us / 1e3:10.3f} ms  {key[:90]}", flush=True)
    return n_ops


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
    t_script = time.perf_counter()
    if min(args.edges, args.ell_inserts) < 256:
        fail("--edges and --ell-inserts must be at least 256")
    if not all((ROOT / "src" / "repro_torch" / "csrc" / f"{k}.cu").is_file()
               for k in KERNELS):
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))   # _torch_levels: B3's level patterns

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
    from repro_torch.kernels.ell.ref import ell_contract_rows_ref, ell_gather_contract_ref
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

    def check_b5_rows(d, idx, ts, labs, ring, what: str) -> None:
        """B5's whole entry (the label gather and the ring folded in)
        against its plain version: one launch, ``torch.equal``."""
        nonlocal ell_err
        before = b5.ell_contract_rows.launches
        out = b5.ell_contract_rows(d, idx, ts, labs, *ring)
        torch.cuda.synchronize()
        if b5.ell_contract_rows.launches != before + 1:
            fail(f"B5's whole entry did not launch once at {what}")
        zero = 0 if d.dtype == torch.int32 else float("-inf")
        ref = ell_contract_rows_ref(d, idx, ts, labs, *ring, zero=zero)
        if not torch.equal(out, ref):   # equal means max |err| 0.0 exactly
            err = (out.float() - ref.float()).abs().masked_fill(out == ref, 0.0)
            ell_err = max(ell_err, float(err.max()))
            fail(f"B5's whole entry differs from its plain version at {what}: "
                 f"max |err| {ell_err}")

    for (j, m, u, e) in B5_CASES + B5_WIDE:
        d, idx, ts, labs, ring = b5_rows_operands(torch, gen, j, m, u, e)
        for lab_t in (labs, labs.long()):
            check_b5_rows(d, idx, ts, lab_t, ring,
                          f"J={j} M={m} U={u} E={e} {lab_t.dtype} labels, full ring")
    print(f"[kernel] B5's whole entry (ELL leaves of 3 labels, a full 64-entry "
          f"ring with out-of-range entries, int32 and int64 labels) == plain "
          f"(torch.equal) on {len(B5_CASES)} test shapes and at U beyond one "
          f"block's shared memory {B5_WIDE}", flush=True)

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
    rec4 = record(svc)   # phase 14's per-event invalidations and fallbacks
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
    e2e_sgts_s = len(tuples) / wall   # phase 13 prints it beside its own
    p4 = phase4_summary(svc, group, report, rec4, tuples, rounds, wall, dense_s,
                        p50, p99)   # phase 14 holds its mesh legs against it
    print(f"[e2e] {len(tuples)} sgts in {wall:.3f} s = "
          f"{e2e_sgts_s:.3f} sgts/s; dispatch p50 {p50 / 1e3:.3f} ms, "
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
    b5_rows = b5_at_path_shapes(torch, ell, check_b5, check_b5_rows)
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

    # -- 13. the supervised service: WAL, checkpoints, crash recovery ----------
    sup13 = supervised_phase(torch, queries, smi_line, args.edges + PROFILE_SGTS,
                             device=None, n_slots=n_slots, n_vertices=n_slots,
                             unsupervised_sgts_s=e2e_sgts_s)

    # -- 14. the mesh executor: lanes and vertices sharded, on the card(s) -----
    mesh14 = mesh_phase(torch, queries, smi_line, p4, bk, device=None,
                        n_slots=n_slots)

    # -- 15. the dry run: one device's share of a round on the production grid
    dry15 = dryrun_phase(torch, smi_line)

    # -- 16. the host-sync census, held against the analyzer's R1 -------------
    census_phase(torch, queries, smi_line, args.edges, args.ell_inserts)

    # -- 17. the LM serving path: prefill and decode at full width ------------
    lm_phase(torch, smi_line)

    # -- 18. LM training: train steps, accumulation, remat, AdamW ------------
    lm_train_phase(torch, smi_line)

    # -- 19. the LM dry run: one device's share of every LM cell ---------------
    lm_dryrun_phase(torch, smi_line)

    # -- 20. live query churn on phase 4's configuration, and the examples ----
    churn20 = churn_phase(torch, queries, smi_line, p4, device=None, n_slots=n_slots)
    print(f"[chip_smoke] phases 1-20: {time.perf_counter() - t_script:.3f} s of the "
          "1200 s limit", flush=True)

    e5, b6p = b5_rows["frontier"], b6_rows["path"]
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
         "minmax_rate": rates,
         # phase 13: its clean and chaos runs, and the breaker leg's dense
         # intervals
         "supervised": {"launches": sup13["b1_launches"],
                        "breaker_launches": sup13["breaker_launches"]["b1"]},
         # phase 14: the mesh legs (lanes, vertices, sparse layouts)
         "mesh": {"launches": {k: mesh14[k]["b1"]
                               for k in ("lanes", "vertices", "sparse")}},
         # phase 15: the dry run's shares (ring, baseline, batched,
         # batched-frontier), each cell's share run 2 + repeats times
         "dryrun": dry15["B1"],
         # phase 20: the churned group's ingests and seeding closures, and
         # the late lanes' oracles apart
         "churn": {"launches": churn20["b1"], "oracle_launches": churn20["oracle_b1"]}},
        row("B2 maxmin_matmul", "maxmin", "src/repro/kernels/maxmin/maxmin.py:67",
            legacy["b2_launches"], lvl_rows["B2"]["max_abs_err"], lvl_rows["B2"]),
        # B3's numbers are on the main path's own operands (phase 10's last
        # round); its uniform and worst-case readings ride along
        {**row("B3 bucket_maxmin_fused", "bucket",
               "src/repro/kernels/bucket/bucket.py:93", bk["launches"][0],
               lvl_rows["B3 uniform"]["max_abs_err"], bk["path"]),
         "path_operands": {k: bk["path"][k] for k in bk["path"] if k not in keys},
         "uniform": lvl_rows["B3 uniform"], "worst": lvl_rows["B3 worst"],
         # phase 14: the mesh's bucket leg
         "mesh": {"launches": {"bucket": mesh14["bucket"]["b3"]}},
         # phase 15: the dry run's mxu and batched-mxu_bucket shares
         "dryrun": dry15["B3"]},
        row("B4 bucket_maxmin", "bucket", "src/repro/kernels/bucket/bucket.py:24",
            legacy["b4_launches"], lvl_rows["B4"]["max_abs_err"], lvl_rows["B4"]),
        # B5's numbers are its whole entry's at the frontier's shape on
        # phase 6's operands (ms the device time); the per-call times, the
        # whole backend call and the dense round's shape ride along
        {**row("B5 ell_contract_rows", "ell", "src/repro/kernels/ell/ell.py:39",
               ell["launches"], ell_err, e5),
         "frontier": {k: e5[k] for k in e5 if k not in keys},
         "dense": b5_rows["dense"],
         # the int32 entry (bucket levels): its launches in phase 10's
         # ELL + row-sparse run, one per frontier round and per dense chunk
         "s32": {"launches": bk_rs["launches"][2],
                 "max_abs_err": lvl_rows["B5-int32"]["max_abs_err"],
                 **lvl_rows["B5-int32"]},
         # phase 13's breaker leg, its sparse intervals
         "supervised": {"breaker_launches": sup13["breaker_launches"]["b5"]},
         # phase 14: not on the mesh path (it densifies the ELL adjacency)
         "mesh": {"launches": sum(v["b5"] + v["b5g"] for v in mesh14.values())}},
        {**row("B6 rowsparse_gather", "rowsparse",
               "src/repro/kernels/rowsparse/rowsparse.py:40", rs["b6_launches"],
               rs_err, b6p),
         # ms and library_ms are device times; per call with the host's
         # enqueue, the host's time per call, and the synthetic shape beside
         "per_call": {k: b6p[k] for k in b6p if k not in keys},
         "synthetic": b6_rows["synthetic"],
         # phase 13's breaker leg, its sparse intervals
         "supervised": {"breaker_launches": sup13["breaker_launches"]["b6"]},
         # phase 14: not on the mesh path (it densifies the row-sparse dist)
         "mesh": {"launches": sum(v["b6"] for v in mesh14.values())}},
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
    from repro_torch.core.semiring import ell_round_chunk
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
    contractions0 = ex.ell_contractions_total
    b1.maxmin_matmul_fused.launches = 0
    b5.ell_contract_rows.launches = 0
    b5.ell_gather_contract.launches = 0
    b6.rowsparse_gather.launches = 0
    t0 = time.perf_counter()
    report = svc.ingest(Stream(tuples), record_latency=True)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b5.ell_contract_rows.launches
    gathers = b5.ell_gather_contract.launches
    b1_launches = b1.maxmin_matmul_fused.launches
    b6_launches = b6.rowsparse_gather.launches
    contractions = ex.ell_contractions_total - contractions0
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

    if b1_launches or gathers:
        fail(f"kernel B1 ran {b1_launches} times and B5's gather-contract entry "
             f"{gathers} times on the {tag} path")
    # one launch per frontier round, one per J chunk of a dense round
    if on_card and not (0 < rounds <= launches == contractions):
        fail(f"B5 launches ({launches}) != the executor's ELL contractions "
             f"({contractions}) over {rounds} closure rounds")
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
          f"launches {launches} == ELL contractions {contractions} (one per "
          f"frontier round, one per J chunk of {ell_round_chunk(J, N)} rows of "
          f"a dense round), B1 launches {b1_launches}, B6 launches "
          f"{b6_launches}", flush=True)
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
        steps0 = ex.steps
        ops = trace_window(torch, lambda: svc.ingest(Stream(tail), record_latency=True),
                           len(tail), f"{tag}-trace", top=10)
        per = ops / max(ex.steps - steps0, 1)
        print(f"[{tag}-trace] {ops} device operations (kernels, copies, fills) "
              f"over {ex.steps - steps0} dispatches = {per:.3f} a dispatch",
              flush=True)

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
        # the final operands of a round, for phase 7: the gathered dist rows,
        # the ELL adjacency and the transition rows' labels
        btt = group.btt
        out.update(d=a.dist[btt.qidx, :, :, btt.src].contiguous(),  # (J, N, N)
                   ell=a.adj, labs=btt.lab.clone())
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


def b5_timed(torch, tag: str, d, adj, labs, backend, reps: int, check_b5_rows,
             check_b5=None):
    """B5 on one of the path's operands: d (J, M, N) against the ELL
    adjacency ``adj`` (its own leaves and ring) and the transition rows'
    labels, float32 timestamps or int32 levels. Both entries
    ``torch.equal`` to their plain versions (``check_b5_rows``,
    ``check_b5``), and the whole entry to the PyTorch yardstick
    (``minimum`` and ``scatter_reduce_(..., "amax")`` of the slot
    candidates, then the same of the ring's; the port never calls it) and
    to ``backend.contract_rows_ell``. Then the whole entry's device time
    (the median of CUDA-graph replays when ``reps`` > 3, else CUDA events
    around back-to-back calls), its time per call with the host's enqueue
    and the wrapper's host time, beside the recounted bound, the plain
    version, the yardstick, the whole backend call and the gather-contract
    entry on pre-gathered rows. Returns the row's numbers."""
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.ell.ref import ell_contract_rows_ref

    j, m, n = d.shape
    n_labels, _, e = adj.idx.shape
    ring = (adj.spill_src, adj.spill_dst, adj.spill_lab, adj.spill_ts)
    src, dst, rlab, sts = ring
    zero = 0 if d.dtype == torch.int32 else float("-inf")
    idx, ts = adj.idx[labs].contiguous(), adj.ts[labs].contiguous()  # gathered rows
    what = f"the {tag} shape J={j} M={m} U={n} E={e}, L={n_labels}, ring {src.numel()}"
    check_b5_rows(d, adj.idx, adj.ts, labs, ring, what)
    if check_b5 is not None:
        check_b5(d, idx, ts, what)
    ring_ts = torch.where(rlab.long()[None] == labs[:, None], sts[None], zero)[:, None]

    def yardstick():
        out = torch.full(d.shape, zero, dtype=d.dtype, device=d.device)
        out.scatter_reduce_(2, idx.long().reshape(j, 1, n * e).expand(-1, m, -1),
                            torch.minimum(d[:, :, :, None], ts[:, None]).reshape(j, m, n * e),
                            "amax", include_self=True)
        return out.scatter_reduce_(2, dst.long()[None, None].expand(j, m, -1),
                                   torch.minimum(d[:, :, src.long()], ring_ts),
                                   "amax", include_self=True)

    kernel = lambda: b5.ell_contract_rows(d, adj.idx, adj.ts, labs, *ring)
    whole = lambda: backend.contract_rows_ell(d, adj, labs)
    gather = lambda: b5.ell_gather_contract(d, idx, ts)
    if not torch.equal(yardstick(), kernel()):
        fail(f"the PyTorch yardstick differs from B5 at {what}")
    if not torch.equal(whole(), kernel()):
        fail(f"contract_rows_ell differs from B5's whole entry at {what}")
    torch.cuda.synchronize()
    if reps > 3:
        ms, ms_each = graph_ms(torch, kernel, reps)
        whole_ms, gather_ms = graph_ms(torch, whole, reps)[0], graph_ms(torch, gather, reps)[0]
    else:
        ms, ms_each = time_cuda(torch, kernel, reps), None
        whole_ms, gather_ms = time_cuda(torch, whole, reps), time_cuda(torch, gather, reps)
    cands = int((d > zero).sum()) * e
    bms, by = bound_ell_ms(j, m, n, e, cands, n_labels, src.numel())
    row = {"ms": ms, "plain_ms": time_cuda(torch, lambda: ell_contract_rows_ref(
               d, adj.idx, adj.ts, labs, *ring, zero=zero), max(1, reps // 10)),
           "library_ms": time_cuda(torch, yardstick, max(1, reps // 3)),
           "bound_ms": bms, "bound_by": by, "shape": [j, m, n, e],
           "n_labels": n_labels, "ring": src.numel(), "live_candidates": cands,
           "ms_graph_replays": ms_each,
           "ms_per_call_with_enqueue": time_cuda(torch, kernel, reps),
           "host_us_per_call": host_us(torch, kernel, reps),
           "contract_rows_ell_ms": whole_ms,
           "contract_rows_ell_ms_per_call_with_enqueue": time_cuda(torch, whole, reps),
           "contract_rows_ell_host_us_per_call": host_us(torch, whole, reps),
           "gather_contract_entry_ms": gather_ms}
    print(f"[kernel] B5{'-int32' if zero == 0 else ''} {tag} shape J={j} M={m} U={n} "
          f"E={e}, L={n_labels}, ring {src.numel()} ({cands} live candidates): device "
          f"{ms:.4f} ms{' (CUDA-graph replay)' if ms_each else ''}, bound {bms:.4f} ms "
          f"({by}), {100 * bms / ms:.1f}% of bound; per call with the enqueue "
          f"{row['ms_per_call_with_enqueue']:.4f} ms, wrapper host "
          f"{row['host_us_per_call']:.1f} us; plain {row['plain_ms']:.3f} ms; yardstick "
          f"{row['library_ms']:.3f} ms; the whole contract_rows_ell call: device "
          f"{whole_ms:.4f} ms, per call "
          f"{row['contract_rows_ell_ms_per_call_with_enqueue']:.4f} ms, host "
          f"{row['contract_rows_ell_host_us_per_call']:.1f} us; the gather-contract "
          f"entry on pre-gathered rows {gather_ms:.4f} ms", flush=True)
    return row


def b5_at_path_shapes(torch, ell, check_b5, check_b5_rows):
    """Phase 7: B5 (``b5_timed``) on phase 6's final operands at the
    frontier's (J, F, N) (the F rows of each transition's slab with the
    most finite entries) and the dense round's (J, N, N) d, float32, and
    at the dense round's shape on those operands encoded to levels (the
    int32 entry; phase 11 times it at the frontier's). Frees the
    operands."""
    from repro_torch.core.contraction import BucketBackend, resolve_backend

    d, adj, labs = ell.pop("d"), ell.pop("ell"), ell.pop("labs")
    j, n, _ = d.shape
    f = ell["frontier_cap"]
    live = (d > float("-inf")).sum(dim=2)                     # (J, N)
    top = torch.topk(live, f, dim=1).indices                  # (J, F)
    d_f = d.gather(1, top[:, :, None].expand(j, f, n)).contiguous()
    rows = {"frontier": b5_timed(torch, "frontier", d_f, adj, labs, resolve_backend("cuda"),
                                 50, check_b5_rows, check_b5)}
    torch.cuda.empty_cache()
    rows["dense"] = b5_timed(torch, "dense", d, adj, labs, resolve_backend("cuda"), 3,
                             check_b5_rows, check_b5)
    torch.cuda.empty_cache()
    # the int32 entry: the operands encoded to levels on the grid of the
    # run's latest timestamp and the 20 s window; the frontier's for phase 11
    enc = BucketBackend(BUCKET_LEVELS)
    now, w = adj.ts.max(), torch.tensor(20.0, device=d.device)
    d_l, adj_l = enc.prepare_state(d, adj, now, w)
    del d
    torch.cuda.empty_cache()
    rows["s32_dense"] = b5_timed(torch, "dense", d_l, adj_l, labs, enc, 3, check_b5_rows)
    del d_l
    rows["s32_operands"] = (enc.encode(d_f, now, w), adj_l, labs)
    del d_f, adj
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
    rec = record(svc)   # phase 14 holds its bucket leg against this run
    dev = ex.arrays.now.device
    timed_part, tail = twin["timed"], twin["tail"]
    tuples = timed_part + tail
    n_del = sum(1 for s in tuples if s.op == "-")
    rounds0, steps0 = ex.rounds_total, ex.steps
    contractions0 = ex.ell_contractions_total
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    b1.maxmin_matmul_fused.launches = 0
    b3.bucket_maxmin_fused.launches = 0
    b5.ell_contract_rows.launches = 0
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
                     f"{tag}-trace", top=12)
    elif tail:
        svc.ingest(Stream(tail))
    launches = (b3.bucket_maxmin_fused.launches, b1.maxmin_matmul_fused.launches,
                b5.ell_contract_rows.launches, b6.rowsparse_gather.launches)
    if b5.ell_gather_contract.launches:
        fail(f"{tag}: B5's gather-contract entry ran on the path")
    contractions = ex.ell_contractions_total - contractions0
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

    # B5: one launch per frontier round, one per J chunk of a dense round
    expected = ((0, 0, contractions) if ell else (rounds, 0, 0)) + (b6_expected,)
    if ell and contractions < rounds:
        fail(f"{tag}: {contractions} ELL contractions over {rounds} rounds")
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
    out = {"J": J, "launches": launches, "rounds": rounds,
           "logs": dense_logs(bg), "inv": rec["inv"]}
    path_ops = None
    if on_card and not ell:
        # B3's operands in the run's last round: the final dist gathered per
        # transition row and the adjacency rows of their labels, encoded on
        # the run's grid
        btt, bk = bg.btt, BucketBackend(n_levels=BUCKET_LEVELS)
        w_max = torch.tensor(bg.max_window, dtype=torch.float32, device=dev)
        path_ops = (bk.encode(ex.dense_dist()[btt.qidx, :, :, btt.src].contiguous(),
                              ex.arrays.now, w_max),
                    bk.encode(ex.dense_adj()[btt.lab].contiguous(), ex.arrays.now, w_max))
    del svc, bg, ex, vb, dist_b
    if on_card:
        torch.cuda.empty_cache()
    if path_ops is not None:
        out["path"] = b3_on_path_operands(torch, *path_ops, BUCKET_LEVELS + 1)
        del path_ops
        torch.cuda.empty_cache()
    return out


#: the tiles of B3's pre-pass flags: a's (64 x 64), b's (64 x 128)
B3_A_TILE, B3_B_TILE = (64, 64), (64, 128)


def b3_steps(torch, a, b, t_levels: int):
    """B3's (warp, k tile, threshold) steps on these operands and their
    share of every step a product without skipping would run, from the
    measurement-only entry of bucket.cu that counts them (its launch is
    not one of the wrapper's)."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.bucket import bucket as b3

    fn = build.bind("bucket", "bucket_maxmin_fused_s32_steps",
                    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 2)
    j, m, k = a.shape
    n = b.shape[2]
    nbytes = b3.scratch_bytes(j, m, k, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    out = torch.empty((j, m, n), dtype=torch.int32, device=a.device)
    count = torch.zeros(1, dtype=torch.int64, device=a.device)
    if fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, j, m,
          k, n, t_levels, count.data_ptr(), torch.cuda.current_stream().cuda_stream):
        fail("the step-counting entry of B3 did not launch")
    torch.cuda.synchronize()
    steps = int(count.item())
    warps = j * -(-m // B3_A_TILE[0]) * -(-n // B3_B_TILE[1]) * 4
    return steps, steps / float(warps * -(-k // B3_A_TILE[1]) * max(t_levels, 1))


def bound_level_data_ms(a, b, t_levels: int):
    """(bound in ms, "bytes" | "operations") of one level product on these
    inputs: the int32 inputs read once and the int32 output written once,
    against the int8 operations the data needs, 2 per (j, i, k, n, theta)
    with a[j, i, k] >= theta and b[j, k, n] >= theta, over 1979 TOP/s."""
    j, m, k = a.shape
    n = b.shape[2]
    pairs = 0.0
    for theta in range(1, t_levels + 1):
        pairs += float(((a >= theta).sum(1).double() * (b >= theta).sum(2).double()).sum())
    t_bytes = 4 * (j * m * k + j * k * n + j * m * n) / PEAK_BYTES
    t_ops = 2.0 * pairs / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def live_tile_share(torch, x, tile) -> float:
    """Share of x's (J, R, C) tiles (the kernel's) holding a level above 0."""
    j, r, c = x.shape
    tr, tc = tile
    pad = torch.nn.functional.pad((x > 0), (0, -c % tc, 0, -r % tr))
    live = pad.view(j, pad.shape[1] // tr, tr, pad.shape[2] // tc, tc).any(4).any(2)
    return float(live.float().mean())


def b3_on_path_operands(torch, d_s, a_l, t_levels: int):
    """After phase 10's dense run: B3 on its own last-round level operands
    (J, N, N) x (J, N, N). torch.equal against the plain version; the share
    of a's and b's pre-pass tiles above level 0 and of the (warp, k tile,
    threshold) steps the product runs; CUDA-event times of B3, the plain
    version and the 9-bmm yardstick beside the bound counted from these
    inputs."""
    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.bucket.ref import bucket_maxmin_fused_ref

    j, m, k = d_s.shape
    n = a_l.shape[2]
    out = b3.bucket_maxmin_fused(d_s, a_l, n_levels=t_levels)
    if not torch.equal(out, bucket_maxmin_fused_ref(d_s, a_l, t_levels)):
        fail("B3 differs from its plain version on phase 10's own operands")
    if not torch.equal(out, bmm_yardstick(torch, d_s, a_l, t_levels)):
        fail("the bmm yardstick differs from B3 on phase 10's own operands")
    del out
    steps, share = b3_steps(torch, d_s, a_l, t_levels)
    row = timed(torch, lambda: b3.bucket_maxmin_fused(d_s, a_l, n_levels=t_levels),
                lambda: bucket_maxmin_fused_ref(d_s, a_l, t_levels),
                lambda: bmm_yardstick(torch, d_s, a_l, t_levels), 20, 1,
                bound_level_data_ms(d_s, a_l, t_levels), [j, m, k, n, t_levels],
                "B3 on phase 10's last-round operands")
    row.update(live_a_tiles=live_tile_share(torch, d_s, B3_A_TILE),
               live_b_tiles=live_tile_share(torch, a_l, B3_B_TILE),
               steps=steps, steps_run=share)
    print(f"[kernel] B3 on phase 10's last-round operands: {row['live_a_tiles']:.4f} of "
          f"a's and {row['live_b_tiles']:.4f} of b's tiles above level 0, "
          f"{share:.6f} of the (warp, k tile, theta) steps run ({steps}); "
          "== plain (torch.equal)", flush=True)
    return row


def bmm_yardstick(torch, x, y, t_levels: int):
    """The library yardstick of B3/B4, which the port never calls: T
    ``torch.matmul`` calls on bf16 0/1 operands (exact: counts up to k stay
    below 2^24 in the float32 accumulator), then the compare and sum."""
    acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=torch.int32, device=x.device)
    for theta in range(1, t_levels + 1):
        acc += (torch.matmul((x >= theta).to(torch.bfloat16),
                             (y >= theta).to(torch.bfloat16)) > 0.5).to(torch.int32)
    return acc


def level_kernels_phase(torch, gen, j_path: int, n: int, b5_rows):
    """Phase 11: B3, B4, B2 and B5-int32 against their plain versions on the
    test shapes and at the path's shapes, then timed beside the bound, the
    plain version and the library yardstick. Returns the JSON rows' data."""
    import numpy as np

    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.bucket.ref import bucket_maxmin_fused_ref, bucket_maxmin_ref
    from repro_torch.core.contraction import BucketBackend
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.ell.ref import ell_contract_rows_ref, ell_gather_contract_ref
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
    # level operands shaped around B3's pre-pass tiles (tests/_torch_levels.py:
    # whole tiles at level 0 in a, b or both, lone corner entries, the worst
    # case, levels outside [0, T]) on ragged, skinny and long-k shapes, and
    # T in {0, 1, 127} beside the path's 9
    from _torch_levels import PATTERNS, level_operands

    rng = np.random.default_rng(16)
    n_patterns = 0
    for pattern in PATTERNS:
        for (j, m, k, nn) in B3_SHAPES:
            for t in (t_lv, 0, 1, 127) if pattern in ("worst", "clamp") else (t_lv,):
                a, b = (torch.from_numpy(x).cuda()
                        for x in level_operands(rng, pattern, j, m, k, nn, t))
                same(b3.bucket_maxmin_fused(a, b, n_levels=t),
                     bucket_maxmin_fused_ref(a, b, t), f"B3 {pattern} at {(j, m, k, nn, t)}")
                same(b3.bucket_maxmin(a[-1].contiguous(), b[-1].contiguous(), n_levels=t),
                     bucket_maxmin_ref(a[-1], b[-1], t), f"B4 {pattern} at {(m, k, nn, t)}")
                n_patterns += 1
    print(f"[kernel] B3, B4 == plain (torch.equal) on {n_patterns} patterned level "
          f"operands ({', '.join(PATTERNS)}) at {B3_SHAPES}", flush=True)
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
    for (j, m, u, e) in B5_CASES + B5_WIDE:
        d, idx, ts, labs, ring = b5_rows_operands(torch, gen, j, m, u, e, levels=True)
        same(b5.ell_contract_rows(d, idx, ts, labs, *ring),
             ell_contract_rows_ref(d, idx, ts, labs, *ring, zero=0),
             f"B5-int32 whole entry at {(j, m, u, e)}, full ring")
    print(f"[kernel] B3, B4 == plain (torch.equal) on 9 test shapes, B2 on "
          f"{len(SHAPES)} float32 and float16, B5-int32 on {len(B5_CASES)} (its "
          f"whole entry with a full ring also at {B5_WIDE})", flush=True)

    rows = {}
    # B3 at the dense round's (J, N, N, N) and the frontier's skinny slabs
    a, b = levels((j_path, n, n), t_lv), levels((j_path, n, n), t_lv)
    for m in SKINNY_M:
        am = a[:, :m].contiguous()
        same(b3.bucket_maxmin_fused(am, b, n_levels=t_lv),
             bucket_maxmin_fused_ref(am, b, t_lv), f"B3 at J={j_path} m={m} N={n}")
    out = b3.bucket_maxmin_fused(a, b, n_levels=t_lv)
    same(out, bucket_maxmin_fused_ref(a, b, t_lv), f"B3 at J={j_path} N={n}")

    if not torch.equal(bmm_yardstick(torch, a, b, t_lv), out):
        fail("the bmm yardstick differs from B3")
    del out
    # uniform levels, then the worst case, where every threshold of every k
    # tile runs: a at T, b at T but for one level-0 column in every 32 (one
    # in each warp tile, whose outputs stay at 0)
    a1, b1_ = a[0].contiguous(), b[0].contiguous()
    for tag in ("uniform", "worst"):
        if tag == "worst":
            del a, b
            torch.cuda.empty_cache()
            a = torch.full((j_path, n, n), t_lv, dtype=torch.int32, device="cuda")
            b = torch.full((j_path, n, n), t_lv, dtype=torch.int32, device="cuda")
            b[:, :, ::32] = 0
            out = b3.bucket_maxmin_fused(a, b, n_levels=t_lv)
            same(out, bucket_maxmin_fused_ref(a, b, t_lv), f"B3 worst case at J={j_path} N={n}")
            if not torch.equal(bmm_yardstick(torch, a, b, t_lv), out):
                fail("the bmm yardstick differs from B3 on the worst case")
            del out
        row = timed(torch, lambda: b3.bucket_maxmin_fused(a, b, n_levels=t_lv),
                    lambda: bucket_maxmin_fused_ref(a, b, t_lv),
                    lambda: bmm_yardstick(torch, a, b, t_lv), 10, 2,
                    bound_level_data_ms(a, b, t_lv), [j_path, n, n, n, t_lv], f"B3 {tag}")
        row["steps"], row["steps_run"] = b3_steps(torch, a, b, t_lv)
        print(f"[kernel] B3 {tag}: {row['steps_run']:.4f} of the (warp, k tile, theta) "
              f"steps run ({row['steps']})", flush=True)
        rows[f"B3 {tag}"] = row
    del a, b
    torch.cuda.empty_cache()
    same(b3.bucket_maxmin(a1, b1_, n_levels=t_lv), bucket_maxmin_ref(a1, b1_, t_lv),
         f"B4 at {n}^3")
    rows["B4"] = timed(torch, lambda: b3.bucket_maxmin(a1, b1_, n_levels=t_lv),
                       lambda: bucket_maxmin_ref(a1, b1_, t_lv),
                       lambda: bmm_yardstick(torch, a1, b1_, t_lv), 20, 5,
                       bound_level_data_ms(a1[None], b1_[None], t_lv), [n, n, n, t_lv],
                       "B4")
    # B2 at (N, N) x (N, N) float32
    x = torch.rand((n, n), generator=gen, device="cuda") * 1000.0
    y = torch.rand((n, n), generator=gen, device="cuda") * 1000.0
    x[torch.rand((n, n), generator=gen, device="cuda") > 0.7] = float("-inf")
    same(b1.maxmin_matmul(x, y), maxmin_matmul_ref(x, y), f"B2 at {n}^3")
    rows["B2"] = timed(torch, lambda: b1.maxmin_matmul(x, y),
                       lambda: maxmin_matmul_ref(x, y), None, 10, 1,
                       bound_ms(1, n, n, n), [n, n, n], "B2")
    # B5-int32 at phase 6's frontier shape, on its operands encoded to levels
    d, adj, labs = b5_rows.pop("s32_operands")

    def check_rows(dd, ell_idx, ell_ts, lab_t, ring, what):
        same(b5.ell_contract_rows(dd, ell_idx, ell_ts, lab_t, *ring),
             ell_contract_rows_ref(dd, ell_idx, ell_ts, lab_t, *ring, zero=0),
             f"B5-int32 at {what}")

    def check_gathered(dd, idx, ts, what):
        same(b5.ell_gather_contract(dd, idx, ts),
             ell_gather_contract_ref(dd, idx, ts, zero=0), f"B5-int32 at {what}")

    rows["B5-int32"] = {**b5_timed(torch, "frontier", d, adj, labs,
                                   BucketBackend(BUCKET_LEVELS), 50, check_rows,
                                   check_gathered),
                        "dense": b5_rows.pop("s32_dense")}
    idx = ts = None
    del adj
    del d, idx, ts, x, y, a1, b1_
    torch.cuda.empty_cache()
    for key, err in errs.items():
        for name in rows:
            if name.split()[0] == key:
                rows[name]["max_abs_err"] = err
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


def executor_tensors(x):
    """Every tensor of an executor's arrays, through the ELL and row-sparse
    leaves."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in executor_tensors(v)]
    return []


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


class SupervisionProbe:
    """Host-clock instrumentation of phase 13 (restored on ``close``):
    wraps the service's ``snapshot`` (the seconds the caller blocks) and
    ``restore`` (its total, checking after each that every executor tensor
    is on ``dev_type``), ``ckpt.restore`` (the npz read), the engine's
    ``adopt_state`` (host padding and placement), ``ckpt._write`` (the
    background write: seconds and bytes) and ``WriteAheadLog.append``
    (append + fsync); and collects every service ``make`` builds."""

    def __init__(self, dev_type: str):
        from repro_torch.checkpoint import ckpt
        from repro_torch.core.engine import BatchedDenseRPQEngine
        from repro_torch.streaming.service import PersistentQueryService
        from repro_torch.streaming.wal import WriteAheadLog

        self.dev_type = dev_type
        self.reset()
        self._patched = []
        probe = self

        def timed(owner, name, sink):
            orig = getattr(owner, name)

            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                sink(time.perf_counter() - t0, args, out)
                return out

            self._patched.append((owner, name, orig))
            setattr(owner, name, wrapper)

        def on_restore(dt, args, _out):
            svc = args[0]
            rec = probe.pending
            probe.pending = {}
            bad = [t.device for t in executor_tensors(svc._group.executor.arrays)
                   if t.device.type != dev_type]
            if bad:
                fail(f"a restore placed executor tensors on {bad[:3]}, not "
                     f"{dev_type}")
            probe.restores.append({**rec, "total_s": dt})

        timed(PersistentQueryService, "snapshot",
              lambda dt, a, o: self.snapshots.append(dt))
        timed(PersistentQueryService, "restore", on_restore)
        timed(ckpt, "restore", lambda dt, a, o: self.pending.__setitem__("read_s", dt))
        timed(BatchedDenseRPQEngine, "adopt_state",
              lambda dt, a, o: self.pending.__setitem__("adopt_s", dt))
        timed(WriteAheadLog, "append", lambda dt, a, o: self.wal.append(dt))
        orig_write = ckpt._write

        def write(directory, step, tree, extra, host_id, crash):
            t0 = time.perf_counter()
            try:
                out = orig_write(directory, step, tree, extra, host_id, crash)
            except ckpt.SimulatedCrash:
                self.writes.append({"s": time.perf_counter() - t0, "bytes": None,
                                    "crash": crash})
                raise
            self.writes.append({"s": time.perf_counter() - t0,
                                "bytes": dir_bytes(out), "crash": None})
            return out

        self._patched.append((ckpt, "_write", orig_write))
        ckpt._write = write

    def reset(self):
        self.snapshots, self.writes, self.restores, self.wal = [], [], [], []
        self.pending = {}
        self.services = []

    def collect(self, make):
        def wrapped(**overrides):
            svc = make(**overrides)
            self.services.append(svc)
            return svc
        return wrapped

    def close(self):
        for owner, name, orig in reversed(self._patched):
            setattr(owner, name, orig)


def register_phase4(svc, queries, n_slots: int):
    """Phase 4's registrations: the 11 queries as one dense group, each
    also a reference RAPQ engine, and the simple-path lanes of Q2 and Q3."""
    for name, expr in queries.items():
        svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
        svc.register(f"{name}_ref", expr, engine="reference")
    for name in ("Q2", "Q3"):
        svc.register(f"{name}_simple", queries[name], engine="dense",
                     path_semantics="simple", n_slots=n_slots, batch_size=1)
    return svc


def supervised_phase(torch, queries, smi: str, n_edges: int, device=None,
                     n_slots: int = 2048, n_vertices: int = 2048,
                     n_inserts: int = SUPERVISED_INSERTS,
                     breaker_inserts: int = BREAKER_INSERTS,
                     unsupervised_sgts_s=None):
    """Phase 13: ``ServiceSupervisor`` over phase 4's configuration and the
    first ``n_inserts`` inserts of its stream (``n_edges`` over
    ``n_vertices``, as phase 4 made it), a clean run and a chaos run, then
    the breaker leg over phase 8's sparse configuration at ``n_slots``.
    ``device``, ``n_slots`` (the vertex slots registered; they grow on
    demand) and the sizes let the same code rehearse on the CPU at a small
    size. Returns the launch counts."""
    import shutil
    import tempfile

    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService, RSPQFallback
    from repro_torch.streaming.stream import SGT
    from repro_torch.streaming.supervisor import FaultPlan, ServiceSupervisor

    on_card = device is None
    window, slide, B, C = 20.0, 2.0, SUPERVISED_BATCH, SUPERVISED_CKPT_EVERY
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    tag = f"[supervised] [{smi}]"

    # phase 4's stream, cut at its n_inserts-th insert, with the three Q3
    # conflict edges after the chaos run's last committed snapshot: its
    # live dispatches are all batches but the one crashed before and the one
    # crashed after dispatch, so its last snapshot ordinal is
    # (n_batches - 2) // C (crashed at "rename"), and the one before commits
    # at lsn (last - 1) * C + 1. No restore reads a snapshot taken after Q3's
    # simple lane fell back (the clean run restores none).
    all_tuples = list(with_deletions(so_like(n_vertices=n_vertices, n_edges=n_edges,
                                             seed=42), ratio=0.02, seed=1))
    cut = [i for i, s in enumerate(all_tuples) if s.op == "+"][n_inserts]
    base = all_tuples[:cut]
    n_batches = -(-(len(base) + 3) // B)
    last = (n_batches - 2) // C
    if last <= 4:
        fail(f"{n_batches} batches hold too few snapshots for the chaos plan")
    first = ((last - 1) * C + 1) * B       # first event after that snapshot
    at = next((i for i, s in enumerate(base) if i >= first and s.op == "+"), None)
    if at is None:
        fail(f"no insert after the last committed snapshot of {n_batches} batches")
    tuples = with_q3_conflict(SGT, base, sum(1 for s in base[at:] if s.op == "+"))
    fallback_lsn = (at + 2) // B + 1

    def make(**overrides):
        svc = PersistentQueryService(window=window, slide=slide, device=device,
                                     **overrides)
        return register_phase4(svc, queries, n_slots)

    probe = SupervisionProbe("cuda" if on_card else "cpu")
    runs = {}
    try:
        for run in ("clean", "chaos"):
            probe.reset()
            plan = None
            if run == "chaos":
                plan = FaultPlan(crash_before_dispatch=[C + 3],
                                 crash_during_replay=[C + 2],
                                 crash_after_dispatch=[n_batches],
                                 crash_mid_snapshot={2: "shards", 4: "manifest",
                                                     last: "rename"},
                                 transient_errors={C + 6: 1})
            d = tempfile.mkdtemp(prefix=f"supervised_{run}_", dir=work)
            try:
                if on_card:
                    torch.cuda.synchronize()
                b1.maxmin_matmul_fused.launches = 0
                t0 = time.perf_counter()
                sup = ServiceSupervisor(probe.collect(make), d, batch_events=B,
                                        ckpt_every=C, fault_plan=plan,
                                        verify_replay=True)
                final = sup.run(list(tuples))
                if on_card:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = b1.maxmin_matmul_fused.launches
                on_disk = dir_bytes(d)
                steps = sorted(p.name for p in Path(d).glob("step_*"))
            finally:
                shutil.rmtree(d, ignore_errors=True)
            rounds = sum(s._group.executor.rounds_total for s in probe.services
                         if s._group is not None)
            if on_card and not 0 < launches == rounds:
                fail(f"{run}: B1 launches ({launches}) != the closure rounds of "
                     f"the {len(probe.services)} services built ({rounds})")
            if plan is not None and not plan.exhausted:
                fail(f"chaos: not every scheduled fault fired: {plan.__dict__}")
            svc = sup.service
            if not isinstance(svc._ref_engines.get("Q3_simple"), RSPQFallback):
                fail(f"{run}: Q3's simple lane did not end on the host RSPQ")
            bad = [n for n in queries if final[n] != final[f"{n}_ref"]]
            if bad:
                fail(f"{run}: dense results differ from the reference RAPQ for {bad}")
            runs[run] = dict(sup=sup, final=final, launches=launches)
            n_ev = len(tuples)
            print(f"{tag} {run}: {n_ev} sgts in {n_batches} batches of {B}, "
                  f"{wall:.3f} s = {n_ev / wall:.3f} sgts/s"
                  f"{f' (phase 4 unsupervised: {unsupervised_sgts_s:.3f})' if unsupervised_sgts_s else ''}; "
                  f"{len(probe.services)} services built, {sup.restarts} restarts, "
                  f"{sup.retries} retries; B1 launches {launches} == closure "
                  f"rounds {rounds}; {len(steps)} step dirs, {on_disk} bytes on "
                  f"disk (removed); Q3 simple fell back at lsn {fallback_lsn}",
                  flush=True)
            wal_ms = sorted(1e3 * x for x in probe.wal)
            print(f"{tag} {run}: WAL append + fsync {sum(wal_ms) / len(wal_ms):.3f} "
                  f"ms a batch (median {wal_ms[len(wal_ms) // 2]:.3f}, max "
                  f"{wal_ms[-1]:.3f}) over {len(wal_ms)} appends", flush=True)
            writes = [w for w in probe.writes if w["crash"] is None]
            for i, (blk, w) in enumerate(zip(probe.snapshots, probe.writes)):
                print(f"{tag} {run} snapshot {i + 1}: caller blocked {blk:.3f} s "
                      f"(drain + device->host), background write {w['s']:.3f} s, "
                      f"{w['bytes'] if w['bytes'] is not None else 'crashed after ' + w['crash']}"
                      f"{' bytes' if w['bytes'] is not None else ''}", flush=True)
            for r in sup.recoveries:
                # every attempt restores once; one that crashed during its
                # replay left no Recovery, so match by attempt number
                rec = probe.restores[r.restart - 1]
                print(f"{tag} {run} recovery {r.restart}: recovery_s "
                      f"{r.recovery_s:.3f}, replayed {r.replayed_events} events in "
                      f"{r.replayed_records} batches = {r.replay_eps:.3f} events/s; "
                      f"restore of step {r.restored_step} {rec['total_s']:.3f} s "
                      f"(npz read {rec['read_s']:.3f} s, adopt_state/place "
                      f"{rec['adopt_s']:.3f} s); executor tensors on "
                      f"{probe.dev_type}", flush=True)
            if writes and run == "clean":
                runs[run]["snapshot_bytes"] = writes[-1]["bytes"]
        clean, chaos = runs["clean"], runs["chaos"]
        cs, xs = clean["sup"], chaos["sup"]
        if xs.result_stream() != cs.result_stream():
            fail("the chaos run's result stream differs from the clean run's")
        if xs.invalidation_stream() != cs.invalidation_stream():
            fail("the chaos run's invalidation stream differs from the clean run's")
        if chaos["final"] != clean["final"]:
            fail("the chaos run's final results differ from the clean run's")
        # five crashes, one more during a replay: six attempts, five recoveries
        if (xs.restarts, len(xs.recoveries)) != (6, 5):
            fail(f"expected 6 restarts and 5 recoveries, got {xs.restarts} and "
                 f"{len(xs.recoveries)}")
        print(f"{tag} chaos == clean: result and invalidation streams over "
              f"{len(cs.result_stream())} batches and final results of all "
              f"{len(clean['final'])} queries; every fault fired; Q3 simple on "
              f"the host RSPQ in both ({len(clean['final']['Q3_simple'])} pairs)",
              flush=True)
        out = {"b1_launches": clean["launches"] + chaos["launches"],
               "snapshot_bytes": clean.get("snapshot_bytes")}
        out.update(breaker_leg(torch, queries, tag, probe, device, n_slots,
                               breaker_inserts))
    finally:
        probe.close()
    return out


def breaker_leg(torch, queries, tag: str, probe, device, n_slots: int,
                n_inserts: int):
    """Phase 13's breaker leg: phase 8's sparse configuration supervised
    clean and with a ``CircuitBreaker`` that trips to the dense fallbacks
    at any overflow and re-arms after one quiet interval. The final results
    must equal the clean run's; B5 and B6 must run as often as the sparse
    services' counters say and B1 as the dense ones' rounds."""
    import shutil
    import tempfile

    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.supervisor import CircuitBreaker, ServiceSupervisor

    on_card = device is None
    tuples = list(with_deletions(so_like(n_vertices=n_slots, n_edges=n_inserts,
                                         seed=7, rate=50.0), ratio=0.02, seed=5))

    def make(**overrides):
        kw = {**ELL_LAYOUT, **RS_DIST, **overrides}
        svc = PersistentQueryService(window=20.0, slide=2.0, device=device, **kw)
        for name, expr in queries.items():
            svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
            svc.register(f"{name}_ref", expr, engine="reference")
        return svc

    finals, counts = {}, {}
    for run in ("clean", "breaker"):
        probe.reset()
        breaker = (CircuitBreaker(trip_threshold=0.0, rearm_after=1)
                   if run == "breaker" else None)
        b1.maxmin_matmul_fused.launches = 0
        b5.ell_contract_rows.launches = 0
        b6.rowsparse_gather.launches = 0
        d = tempfile.mkdtemp(prefix=f"breaker_{run}_", dir=ROOT / "build")
        try:
            t0 = time.perf_counter()
            sup = ServiceSupervisor(probe.collect(make), d, batch_events=SUPERVISED_BATCH,
                                    ckpt_every=10 ** 9, health_every=BREAKER_HEALTH_EVERY,
                                    breaker=breaker, verify_replay=True)
            finals[run] = sup.run(list(tuples))
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        want = {"b1": 0, "b5": 0, "b6": 0}
        n_dense = 0
        for svc in probe.services:
            ex = svc._group.executor
            if ex.adj_layout == "dense":
                n_dense += 1
                want["b1"] += ex.rounds_total
            else:
                f = ex.frontier_stats
                want["b5"] += ex.ell_contractions_total
                want["b6"] += ((f["dispatches"] - f["delete_dispatches"])
                               - (f["fallbacks"] - f["delete_fallbacks"]))
        got = {"b1": b1.maxmin_matmul_fused.launches,
               "b5": b5.ell_contract_rows.launches,
               "b6": b6.rowsparse_gather.launches}
        if on_card and got != want:
            fail(f"breaker leg {run}: launches {got} != the services' counters {want}")
        bad = [n for n in queries if finals[run][n] != finals[run][f"{n}_ref"]]
        if bad:
            fail(f"breaker leg {run}: results differ from the reference RAPQ for {bad}")
        counts[run] = got
        actions = [a for _i, a, _r in breaker.log] if breaker else []
        print(f"{tag} breaker leg {run}: {len(tuples)} sgts in {wall:.3f} s = "
              f"{len(tuples) / wall:.3f} sgts/s; {len(probe.services)} services "
              f"({n_dense} dense); breaker {actions or 'none'}; launches B1 "
              f"{got['b1']}, B5 {got['b5']}, B6 {got['b6']} == the services' "
              f"counters", flush=True)
        for blk, w in zip(probe.snapshots, probe.writes):
            print(f"{tag} breaker leg handover snapshot: {blk:.3f} s "
                  f"(synchronous), write {w['s']:.3f} s, {w['bytes']} bytes",
                  flush=True)
        for rec in probe.restores:
            print(f"{tag} breaker leg handover restore {rec['total_s']:.3f} s (npz "
                  f"read {rec['read_s']:.3f} s, adopt_state/place "
                  f"{rec['adopt_s']:.3f} s)", flush=True)
        if run == "breaker":
            if "trip" not in actions or "rearm" not in actions:
                fail(f"the breaker did not trip and re-arm: {breaker.log}")
            if on_card and min(got.values()) <= 0:
                fail(f"a kernel of the breaker leg never ran: {got}")
    if finals["breaker"] != finals["clean"]:
        fail("the breaker run's final results differ from the clean run's")
    print(f"{tag} breaker leg: final results == the clean run's for all "
          f"{len(finals['clean'])} queries", flush=True)
    return {"breaker_launches": counts["breaker"]}


def record(svc):
    """Instrument a service's dense group for phase 14's comparisons: per
    event its deletion invalidations (event time, lane name, pairs), and per
    RSPQ fallback the stream time of the switch and the lane's per-event
    log until then (the group clears it). Changes nothing the service
    computes."""
    svc._ensure_group()
    group = svc._group
    rec = {"inv": [], "fallback_at": {}, "fallback_log": {}}
    delete_batch, maybe_fallback = group.delete_batch, svc._maybe_fallback

    def delete_recorded(edges):
        out = delete_batch(edges)
        t = max(e[3] for e in edges)
        rec["inv"].extend((t, spec.name, frozenset(out[qi]))
                          for qi, spec in group.live_items() if out[qi])
        return out

    def fallback_recorded(fallbacks, resolve_cb):
        before = set(fallbacks)
        logs = {spec.name: list(group.per_query_log[qi])
                for qi, spec in group.live_items()}
        maybe_fallback(fallbacks, resolve_cb)
        for name in set(fallbacks) - before:
            rec["fallback_at"][name] = group.host_now
            rec["fallback_log"][name] = logs[name]

    group.delete_batch = delete_recorded
    svc._maybe_fallback = fallback_recorded
    return rec


def dense_logs(group):
    """Each live dense lane's per-event result stream, by lane name."""
    return {spec.name: by_event(group.per_query_log[qi])
            for qi, spec in group.live_items()}


def phase4_summary(svc, group, report, rec, tuples, rounds: int, wall: float,
                   dense_s: float, p50: float, p99: float):
    """What phase 14 holds its mesh legs against: phase 4's stream, its
    per-event result logs and invalidations, its results and fallbacks,
    its closure rounds and its rates."""
    rec = {"inv": list(rec["inv"]), "fallback_at": dict(rec["fallback_at"]),
           "fallback_log": dict(rec["fallback_log"])}   # later ingests go on
    return {"tuples": list(tuples), "logs": dense_logs(group), "rec": rec,
            "results": {name: set(svc.results(name)) for name in svc.stats},
            "invalidated": report.invalidated,
            "fallbacks": dict(report.fallbacks), "rounds": rounds,
            "sgts_s": len(tuples) / wall, "dense_sgts_s": len(tuples) / dense_s,
            "p50": p50, "p99": p99}


def upto(t_end: float, logs=None, inv=None):
    """Per-event logs (or the invalidation log) cut at event time t_end."""
    if inv is not None:
        return [e for e in inv if e[0] <= t_end]
    return {name: {t: p for t, p in log.items() if t <= t_end}
            for name, log in logs.items()}


def mesh_phase(torch, queries, smi: str, p4, bucket_run, device=None,
               n_slots: int = 2048, prefix_inserts: int = MESH_PREFIX_INSERTS):
    """Phase 14: the mesh executor through the service, over phase 4's
    configuration (the 11 queries and the simple lanes of Q2 and Q3, no
    reference engines) on ``MESH_DEVICES`` shards (one card's, or one per
    card on a machine with four), in four
    legs held against phase 4's run (``p4``, from ``phase4_summary``),
    phase 10's dense bucket run (``bucket_run``) and a local run: (a) lanes
    (4x1) on phase 4's whole stream; (b) vertices (2x2) and (c) the sparse
    layouts (2x2: frontier "auto", ELL, row-sparse; also against a local
    run of that configuration) and (d) the bucket backend (4x1), each on
    the first ``prefix_inserts`` inserts. Per leg: results, per-event
    result logs and invalidations equal, the fallback at the same event,
    the skip identity, and B1 (B3) launched once per shard-round per model
    peer, B5 and B6 never. ``device`` and ``n_slots`` let it rehearse on
    the CPU (where no kernel launches). Returns each leg's launches by
    kernel ("b1", "b3", "b5", "b5g", "b6")."""
    from repro_torch.core.contraction import BucketBackend
    from repro_torch.distributed.executor import MeshExecutor
    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.stream import Stream

    on_card = device is None
    kernels = {"b1": b1.maxmin_matmul_fused, "b3": b3.bucket_maxmin_fused,
               "b5": b5.ell_contract_rows, "b5g": b5.ell_gather_contract,
               "b6": b6.rowsparse_gather}
    tuples = p4["tuples"]
    cut = [i for i, s in enumerate(tuples) if s.op == "+"][prefix_inserts]
    prefix = tuples[:cut]
    t_end = prefix[-1].ts
    window, slide = 20.0, 2.0

    def run(tag, executor, part, backend=None, simple=True, **layout):
        """One service over ``part`` with its counts set to 0 just before
        the ingest and read just after. On the lane grid (4 lane shards) a
        shard-round must be skipped; the 2x2 grid's two lane shards each
        hold a lane of the deepest queries (Q4 and Q9 close over every
        label), so there they may converge together."""
        svc = PersistentQueryService(window=window, slide=slide, executor=executor,
                                     device=device, **layout)
        kw = {} if backend is None else {"backend": backend}
        for name, expr in queries.items():
            svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1,
                         **kw)
        if simple:
            for name in ("Q2", "Q3"):
                svc.register(f"{name}_simple", queries[name], engine="dense",
                             path_semantics="simple", n_slots=n_slots,
                             batch_size=1, **kw)
        rec = record(svc)
        group = svc._group
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        report = svc.ingest(Stream(part), record_latency=True)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        lat = sorted(svc.stats["Q1"].latencies_us)
        out = {"svc": svc, "group": group, "rec": rec, "report": report,
               "launches": launches, "logs": dense_logs(group), "wall": wall,
               "sgts_s": len(part) / wall, "p50": lat[len(lat) // 2],
               "p99": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
               "peak": torch.cuda.max_memory_allocated() if on_card else 0}
        ex = group.executor
        if isinstance(ex, MeshExecutor):
            n_sh, n_m = ex.n_shards, ex.n_model
            sr, sync = ex.shard_rounds_total, ex.sync_rounds_total
            skipped = ex.skipped_shard_rounds_total
            if sr + skipped != n_sh * sync:
                fail(f"{tag}: shard-rounds {sr} + skipped {skipped} != "
                     f"{n_sh} x sync rounds {sync}")
            if n_sh == MESH_DEVICES and skipped <= 0:
                fail(f"{tag}: no shard-round was skipped")
            kern = "b3" if backend is not None else "b1"
            want = {k: 0 for k in kernels}
            want[kern] = n_m * sr
            if on_card and launches != want:
                fail(f"{tag}: launches {launches} != {want} ({n_m} model peers x "
                     f"{sr} shard-rounds)")
            out.update(shard_rounds=sr, sync_rounds=sync, skipped=skipped)
            print(f"[{tag}] {ex.n_shards}x{ex.n_model} grid over "
                  f"{sorted({str(d) for row in ex.grid for d in row})}: "
                  f"{len(part)} sgts in {wall:.3f} s = {out['sgts_s']:.3f} sgts/s, "
                  f"dispatch p50 {out['p50'] / 1e3:.3f} ms, p99 "
                  f"{out['p99'] / 1e3:.3f} ms (phase 4, local, same run: "
                  f"{p4['sgts_s']:.3f} sgts/s with its reference engines, "
                  f"{p4['dense_sgts_s']:.3f} for its dense group alone, p50 "
                  f"{p4['p50'] / 1e3:.3f} ms, p99 {p4['p99'] / 1e3:.3f} ms); "
                  f"shard-rounds run {sr} of {n_sh} x {sync} sync rounds, "
                  f"{skipped} skipped ({skipped / max(n_sh * sync, 1):.3f}); "
                  f"{ex.steps} dispatches, host syncs "
                  f"{group.host_syncs / max(ex.steps, 1):.3f} a dispatch; launches "
                  f"{launches}; peak device memory {out['peak']} bytes "
                  f"({out['peak'] / 2**30:.3f} GiB); {smi}", flush=True)
        return out

    def same(tag, got, want_logs, want_inv, what):
        bad = [n for n in want_logs if got["logs"].get(n) != want_logs[n]]
        if bad:
            fail(f"{tag}: per-event result logs differ from {what} for {bad}")
        if got["rec"]["inv"] != want_inv:
            fail(f"{tag}: per-event deletion invalidations differ from {what}")

    # the shards go round the visible cards: all on one card, or one a card
    grid4 = ([f"cuda:{i % torch.cuda.device_count()}" for i in range(MESH_DEVICES)]
             if on_card else [device] * MESH_DEVICES)
    legs = {}

    # (a) lanes: phase 4's whole stream
    a = run("mesh-lanes", MeshExecutor(grid4), tuples)
    same("mesh-lanes", a, p4["logs"], p4["rec"]["inv"], "phase 4's")
    bad = [n for n in a["svc"].stats if set(a["svc"].results(n)) != p4["results"][n]]
    if bad:
        fail(f"mesh-lanes: results differ from phase 4's for {bad}")
    if any(a["report"].invalidated[n] != p4["invalidated"][n] for n in a["svc"].stats):
        fail("mesh-lanes: deletion invalidations differ from phase 4's")
    if a["report"].fallbacks != p4["fallbacks"]:
        fail("mesh-lanes: fallbacks differ from phase 4's")
    for key in ("fallback_at", "fallback_log"):
        if a["rec"][key] != p4["rec"][key]:
            fail(f"mesh-lanes: the RSPQ fallback ({key}) differs from phase 4's")
    if a["sync_rounds"] != p4["rounds"]:
        fail(f"mesh-lanes: sync rounds {a['sync_rounds']} != phase 4's closure "
             f"rounds {p4['rounds']}")
    print(f"[mesh-lanes] results, per-event result logs and invalidations == "
          f"phase 4's for all {len(a['svc'].stats)} queries; "
          f"{sorted(p4['fallbacks'])} fell back at the same stream times "
          f"{a['rec']['fallback_at']}; sync rounds == phase 4's "
          f"{p4['rounds']} closure rounds", flush=True)
    legs["lanes"] = a["launches"]
    del a

    p4_prefix = upto(t_end, logs=p4["logs"])
    p4_prefix_inv = upto(t_end, inv=p4["rec"]["inv"])

    # (b) vertices: a 2x2 grid on the prefix
    b = run("mesh-vertices", MeshExecutor(grid4, model_axis=2), prefix)
    same("mesh-vertices", b, p4_prefix, p4_prefix_inv, "phase 4's prefix")
    print(f"[mesh-vertices] per-event result logs and invalidations == phase 4's "
          f"over its first {len(prefix)} sgts", flush=True)
    legs["vertices"] = b["launches"]
    del b

    # (c) the sparse layouts, relaxed as dense slabs: a 2x2 grid and a local
    # run of the same configuration, on the prefix
    sparse = dict(**ELL_LAYOUT, **RS_DIST)
    c = run("mesh-sparse", MeshExecutor(grid4, model_axis=2, **sparse), prefix)
    local = run("mesh-sparse-local", "local", prefix, **sparse)
    same("mesh-sparse", c, local["logs"], local["rec"]["inv"],
         "the local run of the same configuration")
    same("mesh-sparse", c, p4_prefix, p4_prefix_inv, "phase 4's prefix")
    fst = c["group"].executor.frontier_stats
    print(f"[mesh-sparse] per-event result logs and invalidations == the local "
          f"sparse run's ({local['sgts_s']:.3f} sgts/s, p50 "
          f"{local['p50'] / 1e3:.3f} ms, launches {local['launches']}) and phase "
          f"4's prefix; frontier {fst['dispatches']} dispatches, "
          f"{fst['fallbacks']} shard fallbacks, final cap {fst['cap']}; "
          f"dist {c['group'].executor.dist_stats['drains']} drains, lost "
          f"{c['group'].executor.dist_stats['lost']}", flush=True)
    legs["sparse"] = c["launches"]
    del c, local

    # leg (c)'s configuration again over its first sgts, every ingest and
    # delete dispatch under the spy (a dispatch-mode hook on every operator:
    # slow, so apart from the timed run)
    from _torch_spy import spy_dispatches

    svc = PersistentQueryService(window=window, slide=slide, device=device,
                                 executor=MeshExecutor(grid4, model_axis=2, **sparse))
    for name, expr in queries.items():
        svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
    for name in ("Q2", "Q3"):
        svc.register(f"{name}_simple", queries[name], engine="dense",
                     path_semantics="simple", n_slots=n_slots, batch_size=1)
    svc._ensure_group()
    ex = svc._group.executor
    spy = spy_dispatches(ex)
    q, n, _, k = ex.dist_shape
    j_s = max(t.qidx.shape[0] for t in ex._lane_tables(svc._group.tables)[0])
    if j_s * n * n >= q * n * n * k or j_s == ex.adj_shape[0]:
        fail(f"mesh-spy: a (J_s={j_s}, N, N) partial would pass for a whole slab")
    svc.ingest(Stream(prefix[:MESH_SPY_SGTS]))
    if spy.new or spy.moved:
        fail(f"mesh-spy: a dispatch built a whole slab {spy.new[:4]} or moved "
             f"an adjacency block {spy.moved[:4]}")
    print(f"[mesh-spy] leg (c)'s configuration over its first {MESH_SPY_SGTS} "
          f"sgts ({ex.steps} dispatches): no whole (L, N, N) = "
          f"{ex.adj_shape} adjacency or (Q, N, N, K) = {ex.dist_shape} dist "
          f"allocated, no adjacency block moved; ELL replicas on "
          f"{sorted(str(d) for d in ex._ell_reps)}", flush=True)
    del svc, ex

    # (d) the bucket backend on the lane grid, against phase 10's dense run
    d = run("mesh-bucket", MeshExecutor(grid4, backend=BucketBackend(BUCKET_LEVELS)),
            prefix, backend=BucketBackend(BUCKET_LEVELS), simple=False)
    same("mesh-bucket", d, upto(t_end, logs=bucket_run["logs"]),
         upto(t_end, inv=bucket_run["inv"]), "phase 10's dense bucket run")
    print(f"[mesh-bucket] per-event result logs and invalidations == phase 10's "
          f"dense bucket run over its first {len(prefix)} sgts", flush=True)
    legs["bucket"] = d["launches"]
    del d
    if on_card:
        torch.cuda.empty_cache()
    return legs


def dryrun_phase(torch, smi: str, device=None, cells=None, results_dir=None,
                 repeats: int = DRYRUN_REPEATS):
    """Phase 15: ``repro_torch.launch.dryrun_rpq`` on the 16x16 grid for
    ``cells`` (default: its RPQ_CELLS) and ``DRYRUN_MODES``, each record
    forced anew; at the first cell every share is held against its plain
    version. B1's and B3's counters are set to 0 just before and read just
    after: each cell's share runs once, once as the warm-up and
    ``repeats`` times timed, so the phase launches (2 + repeats) x each
    share's own launches. ``device``, ``cells`` and ``results_dir`` let it
    rehearse on the CPU at a tiny cell. Returns the launches by kernel and
    cell/mode, and the records."""
    from repro_torch.kernels.bucket import bucket as b3
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.launch import dryrun_rpq as dr

    on_card = device is None
    cells = dr.RPQ_CELLS if cells is None else cells
    b1.maxmin_matmul_fused.launches = 0
    b3.bucket_maxmin_fused.launches = 0
    want = {"B1": 0, "B3": 0}
    out = {"B1": {}, "B3": {}, "records": []}
    t0 = time.perf_counter()
    for i, (name, n, query, vc) in enumerate(cells):
        for mode in DRYRUN_MODES:
            r = dr.run_rpq_cell(name, n, query, vc, False, force=True, mode=mode,
                                device=device, repeats=repeats,
                                check_plain=i == 0, results_dir=results_dir)
            tag = f"{name}/{mode}"
            if on_card and r["launches"] != r["expected_launches"]:
                fail(f"dryrun {tag}: launches {r['launches']} != "
                     f"{r['expected_launches']}")
            if i == 0 and not r["plain_equal"]:
                fail(f"dryrun {tag}: the share differs from its plain version "
                     f"(max abs err {r['max_abs_err']})")
            if on_card and not r["fits_hbm"]:
                fail(f"dryrun {tag}: peak {r['peak_bytes_per_chip']} B exceeds the card")
            for kern in want:
                want[kern] += (2 + repeats) * r["launches"][kern]
                if r["launches"][kern]:
                    out[kern][tag] = (2 + repeats) * r["launches"][kern]
            plain = (f"; plain version {r['plain_ms']} ms, equal"
                     if i == 0 else "")
            print(f"[dryrun] {tag} x {r['mesh']} device (0, 0) "
                  f"{r['block_shapes']}: {r['device_ms']} ms a share (mean of "
                  f"{repeats}), bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                  f"launches {r['launches']}, peak {r['peak_bytes_per_chip']} B "
                  f"of {r['state_bytes_per_chip']:.0f} B state a chip, fits "
                  f"{r['fits_hbm']}, wire {r['collective_wire_bytes_extrap']:.0f} "
                  f"B/round {r['collectives_by_kind_extrap']}{plain}; "
                  f"{r['device']}", flush=True)
            out["records"].append(r)
    got = {"B1": b1.maxmin_matmul_fused.launches,
           "B3": b3.bucket_maxmin_fused.launches}
    if on_card and got != want:
        fail(f"dryrun: launches {got} != the shares' {want}")
    print(f"[dryrun] {len(out['records'])} records in "
          f"{time.perf_counter() - t0:.3f} s; launches {got}; {smi}", flush=True)
    return out


class SyncCensus:
    """Phase 16's recorder: inside ``with census:`` (on the card, under
    ``torch.cuda.set_sync_debug_mode("warn")``, reset on exit) every sync
    warning is charged to its innermost stack frame under
    ``src/repro_torch/``; frames of ``repro_torch/device.py`` are skipped,
    so a ``device_get`` is charged to its caller's line. ``sites`` maps
    (path from the repo root, line, function qualname) to syncs;
    ``unattributed`` counts warnings with no such frame."""

    def __init__(self, torch, on_card: bool):
        self.torch, self.on_card = torch, on_card
        self.pkg = str(ROOT / "src" / "repro_torch") + os.sep
        self.skip = str(ROOT / "src" / "repro_torch" / "device.py")
        self.sites = collections.Counter()
        self.unattributed = 0

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return self._forward(message, category, filename, lineno, file, line)
        frame = sys._getframe(1)
        while frame is not None:
            path = frame.f_code.co_filename
            if path.startswith(self.pkg) and path != self.skip:
                # comprehensions, lambdas and closures' <locals> fold into
                # the analyzer's dotted qualname of the function
                qual = ".".join(p for p in frame.f_code.co_qualname.split(".")
                                if not p.startswith("<"))
                self.sites[(os.path.relpath(path, ROOT), frame.f_lineno, qual)] += 1
                return None
            frame = frame.f_back
        self.unattributed += 1
        return None

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._forward = warnings.showwarning
        warnings.showwarning = self._show
        if self.on_card:
            self._mode = self.torch.cuda.get_sync_debug_mode()
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        try:
            if self.on_card:
                self.torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self._catch.__exit__(*exc)
        return False


def census_phase(torch, queries, smi: str, edges: int, ell_inserts: int,
                 device=None, dense_slots: int = 2048, sparse_slots: int = ELL_SLOTS,
                 n_inserts: int = CENSUS_INSERTS, out_dir=None):
    """Phase 16: the host-sync census. Phase 4's configuration (the dense
    default, B1) and phase 8's (frontier + ELL + row-sparse, B5 and B6)
    each take the first ``n_inserts`` insert sgts of that phase's stream
    (cut for time) with every sync the card reports recorded
    (:class:`SyncCensus`), then held against ``repro_torch.analysis``: every
    site inside a function that R1's dispatch roots reach is an R1 finding
    at that line; in the dense run the syncs at the fixpoint loop's line
    equal the growth of the executor's ``host_syncs``; no kernel wrapper
    syncs. Prints each site's file:line, function, whether R1 reaches it
    and its syncs a dispatch, and writes the census to
    ``chiprun_out/census/``. ``device`` and the sizes let it rehearse on the
    CPU, where nothing syncs and only the bookkeeping runs."""
    from repro_torch.analysis.analyzer import load_project, run_project
    from repro_torch.analysis.rules.r1_dispatch_syncs import port_roots
    from repro_torch.kernels.ell import ell as b5
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.kernels.rowsparse import rowsparse as b6
    from repro_torch.streaming.generators import so_like, with_deletions
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.stream import Stream

    on_card = device is None
    t_phase = time.perf_counter()
    project = load_project([str(ROOT / "src" / "repro_torch")], root=str(ROOT))
    graph = project.callgraph(port_roots())
    r1 = run_project(project, ["R1"])
    r1_lines = {(f.path, f.line): f for f in r1}
    loop = [f for f in r1 if "`_masked_closure_loop`" in f.message]
    if len(loop) != 1:
        fail(f"expected one R1 finding in the fixpoint loop, got {loop}")
    loop_site = (loop[0].path, loop[0].line)
    window, slide = 20.0, 2.0

    def first_inserts(stream):
        tuples = list(stream)
        cut = [i for i, s in enumerate(tuples) if s.op == "+"][n_inserts]
        return tuples[:cut]

    runs = []
    for tag, layout, n_slots, stream in (
            ("dense", {}, dense_slots, with_deletions(so_like(
                n_vertices=dense_slots, n_edges=edges + PROFILE_SGTS, seed=42),
                ratio=0.02, seed=1)),
            ("sparse", {**ELL_LAYOUT, **RS_DIST}, sparse_slots,
             with_deletions(so_like(n_vertices=sparse_slots,
                                    n_edges=ell_inserts + PROFILE_SGTS, seed=7,
                                    rate=50.0), ratio=0.02, seed=5))):
        tuples = first_inserts(stream)
        svc = PersistentQueryService(window=window, slide=slide, device=device,
                                     **layout)
        for name, expr in queries.items():
            svc.register(name, expr, engine="dense", n_slots=n_slots, batch_size=1)
        if tag == "dense":
            for name in ("Q2", "Q3"):
                svc.register(f"{name}_simple", queries[name], engine="dense",
                             path_semantics="simple", n_slots=n_slots, batch_size=1)
        group = svc.queries["Q1"]
        ex = group.executor
        census = SyncCensus(torch, on_card)
        steps0, syncs0, rounds0 = ex.steps, ex.host_syncs, ex.rounds_total
        contractions0 = ex.ell_contractions_total
        if on_card:
            torch.cuda.synchronize()
        b1.maxmin_matmul_fused.launches = 0
        b5.ell_contract_rows.launches = 0
        b6.rowsparse_gather.launches = 0
        t0 = time.perf_counter()
        with census:
            svc.ingest(Stream(tuples))
            if on_card:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": b1.maxmin_matmul_fused.launches,
                    "B5": b5.ell_contract_rows.launches,
                    "B6": b6.rowsparse_gather.launches}
        steps = ex.steps - steps0
        grew = ex.host_syncs - syncs0
        rounds = ex.rounds_total - rounds0
        contractions = ex.ell_contractions_total - contractions0
        if census.unattributed:
            fail(f"census {tag}: {census.unattributed} syncs with no frame under "
                 "src/repro_torch/")
        if on_card and tag == "dense" and not 0 < launches["B1"] == rounds:
            fail(f"census {tag}: B1 launches {launches['B1']} != rounds {rounds}")
        if on_card and tag == "sparse" and not (
                0 < launches["B5"] == contractions and launches["B6"] > 0):
            fail(f"census {tag}: B5 launches {launches['B5']} (ELL contractions "
                 f"{contractions}), B6 {launches['B6']}")
        sites = []
        for (path, line, qual), n in census.sites.most_common():
            dotted = project.by_path[path].dotted if path in project.by_path else ""
            finding = r1_lines.get((path, line))
            sites.append({"site": f"{path}:{line}", "function": qual,
                          "reachable": (dotted, qual) in graph.reachable,
                          "r1": (None if finding is None else
                                 "suppressed" if finding.suppressed else "live"),
                          "syncs": n, "per_dispatch": n / max(steps, 1)})
        missed = [s for s in sites if s["reachable"] and s["r1"] is None]
        if missed:
            fail(f"census {tag}: syncs inside dispatch-reachable functions that "
                 f"R1 does not flag: {[(s['site'], s['function']) for s in missed]}")
        kernels = [s for s in sites if s["site"].startswith("src/repro_torch/kernels/")]
        if kernels:
            fail(f"census {tag}: a kernel wrapper syncs: {kernels}")
        at_loop = sum(n for (path, line, _q), n in census.sites.items()
                      if (path, line) == loop_site)
        total = sum(census.sites.values())
        if on_card and not (total and (at_loop or tag != "dense")):
            fail(f"census {tag}: {total} syncs recorded, {at_loop} at the "
                 "fixpoint loop: the census saw nothing")
        if tag == "dense" and total and at_loop != grew:
            fail(f"census {tag}: {at_loop} syncs at the fixpoint loop "
                 f"{loop_site[0]}:{loop_site[1]} != host_syncs growth {grew}")
        print(f"[census] {tag}: {len(tuples)} sgts ({n_inserts} inserts), "
              f"{steps} dispatches, {rounds} closure rounds in {wall:.3f} s; "
              f"{total} syncs = {total / max(steps, 1):.3f} a dispatch at "
              f"{len(sites)} sites; executor host_syncs +{grew} "
              f"({grew / max(steps, 1):.3f} a dispatch), {at_loop} at the "
              f"fixpoint loop {loop_site[0]}:{loop_site[1]}; launches "
              f"{launches}; {smi}", flush=True)
        for s in sites:
            print(f"[census] {tag} {s['site']} {s['function']}: reachable "
                  f"{'yes' if s['reachable'] else 'no'}, R1 {s['r1'] or '-'}, "
                  f"{s['syncs']} syncs = {s['per_dispatch']:.3f} a dispatch",
                  flush=True)
        runs.append({"tag": tag, "n_slots": n_slots, "sgts": len(tuples),
                     "inserts": n_inserts, "dispatches": steps, "rounds": rounds,
                     "wall_s": wall, "syncs": total,
                     "per_dispatch": total / max(steps, 1),
                     "host_syncs_growth": grew, "at_fixpoint_loop": at_loop,
                     "launches": launches, "sites": sites})
        del svc, group, ex
        if on_card:
            torch.cuda.empty_cache()
    out_dir = Path(out_dir) if out_dir is not None else ROOT / "chiprun_out" / "census"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "phase16.json", "w") as fh:
        json.dump({"device": smi, "runs": runs}, fh, indent=1)
    print(f"[census] {time.perf_counter() - t_phase:.3f} s; R1 findings "
          f"{len(r1)} ({sum(f.suppressed for f in r1)} suppressed); every "
          f"reachable site is an R1 finding; record in {out_dir}", flush=True)
    return runs


# -- phase 17: the LM serving path ----------------------------------------------


def lm_max_err(a, b, rel: float):
    """(max |a - b|, whether every |a - b| <= rel * (1 + |b|)), on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= rel * (1.0 + b.abs())).all())


class MoETap:
    """Forward hooks on every MoE module of a model: each call's input
    (no work on the device), so its routing can be recomputed after a
    timed run (:func:`repro_torch.models.moe.route`)."""

    def __init__(self, model):
        from repro_torch.models.moe import MoE

        self.calls = []
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()
                        if isinstance(m, MoE)]

    def _hook(self, module, args, output):
        self.calls.append((module, args[0]))

    def routings(self, cfg):
        """(module, Routing) per recorded call, as the layer routed it."""
        from repro_torch.models.moe import route

        out = []
        for module, x in self.calls:
            b, s, d = x.shape
            g = cfg.moe_groups
            out.append((module, route(module, x.reshape(g, b * s // g, d) if g > 1
                                      else x.reshape(b * s, d),
                                      cfg.experts_per_token, cfg.capacity_factor)))
        return out

    def close(self):
        for h in self.handles:
            h.remove()


def lm_tokens(torch, cfg, b: int, s: int, seed: int, device):
    """``(b, s)`` token ids and the stub frontends' prefix embeddings, from
    a seeded generator on ``device`` (prefix positions count in ``s``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    P = cfg.prefix_len if cfg.frontend != "none" else 0
    tokens = torch.randint(0, cfg.vocab_size, (b, s - P), generator=gen, device=device)
    prefix = (torch.randn((b, P, cfg.d_model), generator=gen, device=device)
              if P else None)
    return tokens, prefix, P


def lm_teacher_forced(model, tokens, prefix, P: int, prompt: int, n_decode: int,
                      max_len: int, sync=None, times=None):
    """Prefill ``prompt`` positions (the prefix included), then
    ``n_decode`` teacher-forced decode steps. Returns the prefill's logits
    and each step's, each (b, V); with ``times`` a list, the host seconds
    of the prefill and of each step (``sync`` after each) are appended."""
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens[:, :prompt - P], prefix, max_len=max_len)
    if sync:
        sync()
    if times is not None:
        times.append(time.perf_counter() - t0)
    out = [logits[:, 0]]
    for i in range(n_decode):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(tokens[:, prompt + i - P][:, None], caches)
        if sync:
            sync()
        if times is not None:
            times.append(time.perf_counter() - t0)
        out.append(logits[:, 0])
    return out


def lm_phase(torch, smi: str, device=None, reduced_full: bool = False, out_dir=None):
    """Phase 17: the LM serving path (``repro_torch.models``), prefill and
    decode. (a) every reduced config on the card against the CPU (float32,
    weights from a seeded CPU generator copied over): forward, loss,
    prefill and teacher-forced decode logits within ``LM_TOL_F32``, MoE
    experts equal; (b) smollm-360m and mamba2-370m at full width in float32:
    the card's forward against the CPU's, and prefill + decode against the
    card's own forward, within ``LM_TOL_F32_FULL``; (c) the bfloat16 serving
    runs of ``LM_SERVE_RUNS``: prefill tokens/s, decode step p50/p99 and
    tokens/s, peak memory, each beside its bound, finite logits, decode
    within ``LM_TOL_BF16`` of the full forward (not dbrx: its capacity
    differs between a decode call and the full forward by design), and for
    dbrx the kept share with kept == min(routed, capacity) per expert;
    (d) one prefill and ``LM_CENSUS_DECODE`` decode steps of the
    ``LM_CENSUS_ARCHS`` runs under the sync census: no sync charged to
    ``src/repro_torch/models/``; (e) the top device kernels of one prefill
    and one decode step of the ``LM_TRACE_ARCHS`` runs. ``device="cpu"`` with
    ``reduced_full=True`` rehearses on the CPU: the full-width runs become
    the reduced configs at small sizes (no timing means anything there)."""
    import dataclasses

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models.transformer import Model

    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    t_phase = time.perf_counter()
    if on_card and (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
        fail("float32 matmuls may use TF32: the float32 checks need IEEE float32")
    held = 0
    if on_card:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
    record = {"device": smi, "held_on_entry_bytes": held, "reduced": [], "float32": [],
              "serve": []}

    # -- (a) every reduced config, card against CPU --------------------------
    t0 = time.perf_counter()
    worst = 0.0
    for seed, arch in enumerate(ARCH_NAMES):
        cfg = get_config(arch).reduced()
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
        card = Model(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        tokens, prefix, P = lm_tokens(torch, cfg, 2, LM_REDUCED["max_len"], seed, "cpu")
        results, routes = [], []
        for m, d in ((cpu, torch.device("cpu")), (card, dev)):
            tap = MoETap(m)
            tk, pe = tokens.to(d), None if prefix is None else prefix.to(d)
            with torch.no_grad():
                logits, aux = m.forward(tk, pe)
                loss = m.loss({"tokens": tk, **({} if pe is None else {"prefix_embeds": pe})})
            steps = lm_teacher_forced(m, tk, pe, P, LM_REDUCED["prompt"],
                                      LM_REDUCED["decode"], LM_REDUCED["max_len"])
            results.append([logits, aux, loss] + steps)
            routes.append([r.expert_idx.cpu() for _m, r in tap.routings(cfg)])
            tap.close()
        err = 0.0
        for what, (a, b) in zip(["forward", "aux", "loss", "prefill"] +
                                [f"decode {i}" for i in range(LM_REDUCED["decode"])],
                                zip(results[1], results[0])):
            e, ok = lm_max_err(a, b, LM_TOL_F32)
            err = max(err, e)
            if not ok:
                fail(f"lm (a) {arch}: {what} on {dev} differs from the CPU: max |err| {e}")
        if len(routes[0]) != len(routes[1]) or not all(
                torch.equal(a, b) for a, b in zip(routes[0], routes[1])):
            fail(f"lm (a) {arch}: the MoE experts on {dev} differ from the CPU's")
        worst = max(worst, err)
        record["reduced"].append({"arch": cfg.name, "max_abs_err": err,
                                  "moe_calls": len(routes[0])})
        del cpu, card
    print(f"[lm] (a) {len(ARCH_NAMES)} reduced configs, float32, {dev} against the CPU: "
          f"forward, loss, prefill of {LM_REDUCED['prompt']}, {LM_REDUCED['decode']} "
          f"teacher-forced decode steps; max |err| {worst:.3e} (tolerance "
          f"{LM_TOL_F32} x (1 + |ref|)); MoE experts equal; "
          f"{time.perf_counter() - t0:.3f} s; {held / 2**30:.3f} GiB held by earlier "
          f"phases; {smi}", flush=True)

    def full(arch, **over):
        cfg = get_config(arch)
        if reduced_full:
            cfg = cfg.reduced()
        return dataclasses.replace(cfg, **over)

    # -- (b) full width, float32: card against CPU, decode against forward --
    for seed, arch in enumerate(LM_F32_ARCHS):
        t0 = time.perf_counter()
        cfg = full(arch, param_dtype="float32")
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(100 + seed))
        card = Model(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        n = LM_F32["tokens"]
        tokens, prefix, P = lm_tokens(torch, cfg, 1, n, 200 + seed, "cpu")
        tokens_d, prefix_d = tokens.to(dev), None if prefix is None else prefix.to(dev)
        with torch.no_grad():
            ref, _ = cpu.forward(tokens, prefix)
            got, _ = card.forward(tokens_d, prefix_d)
        e_cpu, ok = lm_max_err(got, ref, LM_TOL_F32_FULL)
        if not ok:
            fail(f"lm (b) {arch}: the {dev} forward differs from the CPU's: max |err| {e_cpu}")
        steps = lm_teacher_forced(card, tokens_d, prefix_d, P, LM_F32["prompt"],
                                  LM_F32["decode"], n)
        e_dec = 0.0
        for i, lg in enumerate(steps):
            e, ok = lm_max_err(lg, got[:, LM_F32["prompt"] - 1 + i], LM_TOL_F32_FULL)
            e_dec = max(e_dec, e)
            if not ok:
                fail(f"lm (b) {arch}: step {i} of prefill + decode differs from the "
                     f"forward: max |err| {e}")
        params = sum(p.numel() for p in card.parameters())
        print(f"[lm] (b) {arch} full width float32 ({params / 1e6:.1f} M params): "
              f"forward on (1, {n}) {dev} vs CPU max |err| {e_cpu:.3e}; prefill of "
              f"{LM_F32['prompt']} + {LM_F32['decode']} decode steps vs the forward "
              f"max |err| {e_dec:.3e} (tolerance {LM_TOL_F32_FULL} x (1 + |ref|)); max "
              f"|logit| {float(ref.abs().max()):.3f}; {time.perf_counter() - t0:.3f} s; "
              f"{smi}", flush=True)
        record["float32"].append({"arch": arch, "params": params, "err_vs_cpu": e_cpu,
                                  "err_decode_vs_forward": e_dec})
        del cpu, card
        if on_card:
            torch.cuda.empty_cache()

    # -- (c)-(e) full width, bfloat16 serving --------------------------------
    for seed, (arch, b, prompt, n_decode, layers) in enumerate(LM_SERVE_RUNS):
        cfg = full(arch, param_dtype=get_config(arch).param_dtype,
                   **({} if layers is None else {"n_layers": layers}))
        if reduced_full:
            b, prompt, n_decode = 2, 16, min(n_decode, 4)
        record["serve"].append(lm_serve_run(
            torch, cfg, b, prompt, n_decode, 300 + seed, dev, smi,
            census=arch in LM_CENSUS_ARCHS, trace=arch in LM_TRACE_ARCHS,
            cut=layers is not None))
    out_dir = Path(out_dir) if out_dir is not None else ROOT / "chiprun_out" / "lm"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "phase17.json", "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"[lm] phase 17: {time.perf_counter() - t_phase:.3f} s; record in {out_dir}",
          flush=True)
    return record


def lm_serve_run(torch, cfg, b: int, prompt: int, n_decode: int, seed: int, dev,
                 smi: str, census: bool, trace: bool, cut: bool):
    """One bfloat16 serving run of phase 17 (c), with (d) and (e) when asked
    (``cut``: the config's depth was cut)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import roofline as rl
    from repro_torch.models.transformer import Model

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    sync()
    t_init = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    max_len = prompt + n_decode
    tokens, prefix, P = lm_tokens(torch, cfg, b, max_len, seed, dev)
    # warm-up: a short prefill and a decode step (library handles, caches)
    lm_teacher_forced(model, tokens, prefix, P, min(prompt, 64), 1, min(prompt, 64) + 1,
                      sync=sync)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tap = MoETap(model)
    times = []
    steps = lm_teacher_forced(model, tokens, prefix, P, prompt, n_decode, max_len,
                              sync=sync, times=times)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    prefill_s, step_s = times[0], times[1:]
    if not all(bool(torch.isfinite(lg).all()) for lg in steps):
        fail(f"lm (c) {cfg.name}: non-finite logits")
    routed = tap.routings(cfg)
    tap.close()
    n_moe = sum(1 for i in range(cfg.n_layers) if cfg.mlp_kind(i) == "moe")
    kept_pairs, experts_read, kept_share = [], [], None
    if n_moe:
        # the prefill's MoE calls come first, one per MoE layer
        for _module, r in routed[:n_moe]:
            E = cfg.n_experts
            routed_n = torch.bincount(r.expert_idx.reshape(-1), minlength=E)
            kept_n = torch.bincount(r.expert_idx.reshape(-1)[r.keep.reshape(-1)],
                                    minlength=E)
            if not torch.equal(kept_n, routed_n.clamp(max=r.capacity)):
                fail(f"lm (c) {cfg.name}: kept per expert {kept_n.tolist()} != "
                     f"min(routed {routed_n.tolist()}, capacity {r.capacity})")
            kept_pairs.append(int(r.keep.sum()))
        kept_share = sum(kept_pairs) / (n_moe * b * prompt * cfg.experts_per_token)
        for _module, r in routed[n_moe:]:
            experts_read.append(int(torch.unique(r.expert_idx[r.keep]).numel()))
    # the bounds: roofline's count of what the step needs, at the config's
    # own widths, with the kept pairs and the experts read that this run routed
    w = rl.logical_widths(cfg)
    weights = {k: p.numel() * p.element_size() for k, p in model.named_parameters()}
    flops = rl.step_flops(cfg, ShapeConfig("prefill", prompt, b, "prefill"), w, b, 1,
                          cfg.n_layers, needed=True, pairs=kept_pairs or None)[0]
    prefill_bound = max(flops / PEAK_BF16_FLOPS,
                        rl.step_bytes(cfg, "prefill", w, weights, b, prompt) / PEAK_BYTES)
    step_bounds = []
    for i in range(n_decode):
        reads = (experts_read[i * n_moe:(i + 1) * n_moe] if n_moe else None)
        step_bounds.append(rl.step_bytes(cfg, "decode", w, weights, b, prompt + i,
                                         experts_read=reads) / PEAK_BYTES)
    step_ms = sorted(t * 1e3 for t in step_s)
    p50 = step_ms[len(step_ms) // 2]
    p99 = step_ms[min(len(step_ms) - 1, int(round(0.99 * (len(step_ms) - 1))))]
    mean_step = sum(step_ms) / len(step_ms)
    bound_step = sum(step_bounds) / len(step_bounds) * 1e3
    row = {"arch": cfg.name, "layers": cfg.n_layers, "params": params, "batch": b,
           "prompt": prompt, "decode_steps": n_decode, "init_s": t_init,
           "prefill_s": prefill_s, "prefill_tokens_per_s": b * prompt / prefill_s,
           "prefill_flops": flops, "prefill_bound_s": prefill_bound,
           "prefill_bound_tokens_per_s": b * prompt / prefill_bound,
           "decode_p50_ms": p50, "decode_p99_ms": p99, "decode_mean_ms": mean_step,
           "decode_tokens_per_s": b * 1e3 / mean_step, "decode_bound_ms": bound_step,
           "decode_bound_tokens_per_s": b * 1e3 / bound_step, "peak_bytes": peak,
           "kept_share": kept_share}
    # decode against the full forward at the same positions
    if cfg.n_experts == 0:
        with torch.no_grad():
            ref, _ = model.forward(tokens, prefix)
        err = max(float((lg.float() - ref[:, prompt - 1 + i].float()).abs().max())
                  for i, lg in enumerate(steps))
        if not err <= LM_TOL_BF16:
            fail(f"lm (c) {cfg.name}: bfloat16 prefill + decode differ from the full "
                 f"forward by {err} (tolerance {LM_TOL_BF16})")
        row["err_decode_vs_forward"] = err
        row["max_abs_logit"] = float(ref.abs().max())
        del ref
    print(f"[lm] (c) {cfg.name}{' depth cut to ' + str(cfg.n_layers) + ' layers' if cut else ''}, "
          f"bfloat16, {params / 1e9:.3f} B params, batch {b}, prompt {prompt}: prefill "
          f"{row['prefill_tokens_per_s']:.1f} tokens/s ({prefill_s * 1e3:.3f} ms; bound "
          f"{prefill_bound * 1e3:.3f} ms = {row['prefill_bound_tokens_per_s']:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); decode "
          f"{n_decode} steps p50 {p50:.3f} ms p99 {p99:.3f} ms, {row['decode_tokens_per_s']:.1f} "
          f"tokens/s (bound {bound_step:.3f} ms a step = "
          f"{row['decode_bound_tokens_per_s']:.1f} tokens/s, bytes at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s); peak {peak / 2**30:.3f} GiB; "
          + (f"kept {kept_share:.4f} of (token, slot) pairs, kept == min(routed, "
             f"capacity) per expert; " if kept_share is not None else "")
          + (f"decode vs forward max |err| {row['err_decode_vs_forward']:.4f} (max |logit| "
             f"{row['max_abs_logit']:.3f}, tolerance {LM_TOL_BF16}); "
             if "err_decode_vs_forward" in row else "")
          + f"init {t_init:.3f} s; {smi}", flush=True)
    if census:
        n = min(n_decode, LM_CENSUS_DECODE)
        row["census"] = lm_census(
            torch, lambda: lm_teacher_forced(model, tokens, prefix, P, prompt, n, prompt + n),
            on_card, sync, ("src/repro_torch/models/",), f"lm (d) {cfg.name}",
            f"one prefill + {n} decode steps")
    if trace and on_card:
        caches = model.prefill(tokens[:, :prompt - P], prefix, max_len=max_len)[1]
        trace_window(torch, lambda: model.decode_step(tokens[:, prompt - P][:, None],
                                                      caches),
                     1, f"lm-trace {cfg.name}", top=8, unit="decode step")
        del caches
        trace_window(torch, lambda: model.prefill(tokens[:, :prompt - P], prefix,
                                                  max_len=max_len),
                     1, f"lm-trace {cfg.name}", top=8,
                     unit=f"prefill of {b} x {prompt} tokens")
    del model, tokens, steps, routed
    if on_card:
        torch.cuda.empty_cache()
    return row


def lm_census(torch, run, on_card: bool, sync, watched, tag: str, what: str):
    """Phases 17 (d) and 18 (e): ``run()`` under the sync census; no sync
    may be charged to a path that starts with one of ``watched``."""
    census = SyncCensus(torch, on_card)
    sync()
    with census:
        run()
        sync()
    if census.unattributed:
        fail(f"{tag}: {census.unattributed} syncs with no frame under src/repro_torch/")
    bad = {k: n for k, n in census.sites.items() if k[0].startswith(watched)}
    if bad:
        fail(f"{tag}: host syncs charged to {', '.join(watched)}: {bad}")
    total = sum(census.sites.values())
    print(f"[{tag.split()[0]}] {tag.split(' ', 1)[1]}: {what} under the sync census: "
          f"{total} syncs under src/repro_torch/ ({len(census.sites)} sites), 0 in "
          f"{', '.join(watched)}", flush=True)
    return {"syncs": total, "sites": len(census.sites), "unattributed": census.unattributed}

# -- phase 18: LM training ------------------------------------------------------


def lm_update_bytes(model, state, grads) -> int:
    """The bytes AdamW must move: params, grads, m and v read once; params,
    m and v written once."""
    total = 0
    for k, p in model.named_parameters():
        n = p.numel()
        total += n * (2 * p.element_size() + grads[k].element_size()
                      + 2 * state.m[k].element_size() + 2 * state.v[k].element_size())
    return total


def lm_train_check(torch, got, ref, opt, tol: float, what: str):
    """Phase 18's comparison of one train step from zero moments, ``got``
    against ``ref`` (each (model, state, metrics)): loss and grad norm
    within ``tol`` x (1 + |ref|), lr within 1e-6 relative, m and v within
    ``tol`` x (1 + |ref|); every parameter within ``LM_TRAIN_TOL_PARAM`` x
    (1 + |ref|), except where the step's clipped gradient lies within
    ``LM_TRAIN_EPS_G`` (x the clip scale) of zero, read from ref's first
    moment (m = (1 - b1) g after one step): there Adam's first update,
    ~lr * sign(g), may flip, so such an entry may differ by 2 lr more.
    Returns (max |err| over metrics and moments, entries excused)."""
    gm, gs, gmet = got
    rm, rs, rmet = ref
    worst = 0.0
    for k in ("loss", "grad_norm"):
        e, ok = lm_max_err(gmet[k], rmet[k], tol)
        worst = max(worst, e)
        if not ok:
            fail(f"lm-train {what}: {k} {float(gmet[k])} against {float(rmet[k])}")
    lr = float(rmet["lr"])
    if abs(float(gmet["lr"]) - lr) > 1e-6 * lr:
        fail(f"lm-train {what}: lr {float(gmet['lr'])} against {lr}")
    if int(gs.step) != int(rs.step):
        fail(f"lm-train {what}: step {int(gs.step)} against {int(rs.step)}")
    scale = min(1.0, opt.clip_norm / (float(rmet["grad_norm"]) + 1e-9))
    ref_params = dict(rm.named_parameters())
    excused = 0
    for k, p in gm.named_parameters():
        for name, a, b in (("m", gs.m[k], rs.m[k]), ("v", gs.v[k], rs.v[k])):
            e, ok = lm_max_err(a, b, tol)
            worst = max(worst, e)
            if not ok:
                fail(f"lm-train {what}: {name} of {k} differs: max |err| {e}")
        a, b = p.detach().float().cpu(), ref_params[k].detach().float().cpu()
        err, tight = (a - b).abs(), LM_TRAIN_TOL_PARAM * (1 + b.abs())
        near_zero = rs.m[k].float().cpu().abs() <= (1 - opt.b1) * LM_TRAIN_EPS_G * scale
        if not ((err <= tight) | (near_zero & (err <= tight + 2 * lr))).all():
            fail(f"lm-train {what}: parameter {k} differs by {float((err - tight).max())} "
                 f"beyond {LM_TRAIN_TOL_PARAM} x (1 + |ref|) where its gradient is not "
                 f"within {LM_TRAIN_EPS_G} of zero")
        excused += int((err > tight).sum())
    return worst, excused


def lm_train_phase(torch, smi: str, device=None, reduced_full: bool = False, out_dir=None):
    """Phase 18: LM training (``repro_torch.launch.train``, ``repro_torch.
    optim``). (a) every reduced config in float32, the card against the
    CPU from the same seeded weights: one ``make_train_step`` at
    ``microbatches`` 1 and one at 2 (bfloat16 accumulation), held by
    :func:`lm_train_check`; (b) smollm-360m and mamba2-370m at full width in
    float32, one step on ``LM_TRAIN_F32`` tokens, card against CPU, and the
    card's gradients with remat on against remat off; (c) the bfloat16
    runs of ``LM_TRAIN_RUNS`` (the config's ``opt_state_dtype``,
    ``microbatches`` and remat, the CLI's ``AdamWConfig``, a fixed batch):
    warm-up and timed steps, step p50 and tokens/s beside the FLOP bound,
    the update's time beside its byte bound, peak memory, a finite loss
    that falls, and smollm's peak with remat on and off; (d) dbrx-132b cut
    to ``LM_TRAIN_GRADS``' layers: the accumulated gradients, the clip and
    the grad norm without the update (kept share, peak, time, finite);
    (e) two train steps of the qwen run under the sync census: none in
    ``models/``, ``optim/`` or ``launch/train.py``; (f) the top device
    kernels of one qwen step. ``device="cpu"`` with ``reduced_full=True``
    rehearses on the CPU with the reduced configs at small sizes."""
    import dataclasses

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, init_adamw

    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    record = {"device": smi, "reduced": [], "float32": [], "train": [], "grads": None}

    def one_step(model, opt, batch, d):
        state = init_adamw(opt, model)
        return make_train_step(model, opt)(model, state, {k: v.to(d) for k, v in batch.items()})

    # -- (a) every reduced config, M = 1 and 2, card against CPU ------------
    t0 = time.perf_counter()
    worst, excused = 0.0, 0
    for seed, arch in enumerate(ARCH_NAMES):
        for M in (1, 2):
            cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=M)
            opt = AdamWConfig(**LM_TRAIN_OPT, total_steps=LM_TRAIN_STEPS,
                              moment_dtype=cfg.opt_state_dtype)
            base = Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
            card = Model(cfg, device=dev)
            card.load_state_dict(base.state_dict())
            tokens, prefix, _P = lm_tokens(torch, cfg, *LM_TRAIN_REDUCED, seed, "cpu")
            batch = {"tokens": tokens, **({} if prefix is None else {"prefix_embeds": prefix})}
            ref = one_step(base, opt, batch, cpu)
            got = one_step(card, opt, batch, dev)
            e, n = lm_train_check(torch, got, ref, opt, LM_TOL_F32, f"(a) {arch} M={M}")
            worst, excused = max(worst, e), excused + n
            record["reduced"].append({"arch": cfg.name, "microbatches": M, "max_abs_err": e,
                                      "excused": n, "loss": float(ref[2]["loss"])})
            del base, card, ref, got
    print(f"[lm-train] (a) {len(ARCH_NAMES)} reduced configs x microbatches 1 and 2, "
          f"float32, one train step on {dev} against the CPU: loss, grad norm, m, v max "
          f"|err| {worst:.3e} (tolerance {LM_TOL_F32} x (1 + |ref|)); parameters within "
          f"{LM_TRAIN_TOL_PARAM} x (1 + |ref|) but {excused} entries whose gradient lies "
          f"within {LM_TRAIN_EPS_G} of zero (Adam's sign); {time.perf_counter() - t0:.3f} s; "
          f"{smi}", flush=True)

    def full(arch, **over):
        cfg = get_config(arch)
        if reduced_full:
            cfg = cfg.reduced()
        return dataclasses.replace(cfg, **over)

    # -- (b) full width, float32: card against CPU, remat on against off ----
    from repro_torch.launch.train import loss_and_grads

    for seed, arch in enumerate(LM_F32_ARCHS):
        t0 = time.perf_counter()
        cfg = full(arch, param_dtype="float32", microbatches=1, remat=True)
        opt = AdamWConfig(**LM_TRAIN_OPT, total_steps=LM_TRAIN_STEPS)
        base = Model(cfg, device="cpu").init(torch.Generator().manual_seed(400 + seed))
        card = Model(cfg, device=dev)
        card.load_state_dict(base.state_dict())
        tokens, prefix, _P = lm_tokens(torch, cfg, *LM_TRAIN_F32, 500 + seed, "cpu")
        batch = {"tokens": tokens}
        on_loss, on_grads = loss_and_grads(card, {"tokens": tokens.to(dev)})
        card.cfg = dataclasses.replace(cfg, remat=False)
        off_loss, off_grads = loss_and_grads(card, {"tokens": tokens.to(dev)})
        card.cfg = cfg
        e_remat, ok = lm_max_err(on_loss, off_loss, LM_TOL_F32_FULL)
        for k, g in on_grads.items():
            e, ok_k = lm_max_err(g, off_grads[k], LM_TOL_F32_FULL)
            e_remat, ok = max(e_remat, e), ok and ok_k
        if not ok:
            fail(f"lm-train (b) {arch}: gradients with remat on differ from remat off on "
                 f"{dev}: max |err| {e_remat}")
        del on_grads, off_grads
        ref = one_step(base, opt, batch, cpu)
        got = one_step(card, opt, batch, dev)
        e, n = lm_train_check(torch, got, ref, opt, LM_TOL_F32_FULL, f"(b) {arch}")
        params = sum(p.numel() for p in card.parameters())
        print(f"[lm-train] (b) {arch} full width float32 ({params / 1e6:.1f} M params), one "
              f"train step on {LM_TRAIN_F32} tokens, {dev} against the CPU: loss "
              f"{float(ref[2]['loss']):.4f}, grad norm {float(ref[2]['grad_norm']):.4f}; "
              f"loss, grad norm, m, v max |err| {e:.3e}; parameters within "
              f"{LM_TRAIN_TOL_PARAM} x (1 + |ref|) but {n} near-zero-gradient entries; "
              f"remat on vs off on {dev}: loss and gradients max |err| {e_remat:.3e} "
              f"(tolerance {LM_TOL_F32_FULL} x (1 + |ref|)); "
              f"{time.perf_counter() - t0:.3f} s; {smi}", flush=True)
        record["float32"].append({"arch": arch, "params": params, "max_abs_err": e,
                                  "excused": n, "remat_err": e_remat})
        del base, card, ref, got
        if on_card:
            torch.cuda.empty_cache()

    # -- (c), (e), (f): bfloat16 training at full width -----------------------
    for seed, (arch, b, s, layers) in enumerate(LM_TRAIN_RUNS):
        cfg = full(arch, **({} if layers is None else {"n_layers": layers}))
        if reduced_full:
            b, s = 4, 32
        record["train"].append(lm_train_run(
            torch, cfg, b, s, 600 + seed, dev, smi, cut=layers is not None,
            remat_peak=arch == LM_TRAIN_REMAT_ARCH,
            census_trace=arch == LM_TRAIN_CENSUS_ARCH))

    # -- (d) dbrx cut: accumulated gradients, clip and norm, no update --------
    arch, b, s, layers = LM_TRAIN_GRADS
    cfg = full(arch, n_layers=layers)
    if reduced_full:
        b, s = 8, 32
    record["grads"] = lm_grads_run(torch, cfg, b, s, 700, dev, smi)

    out_dir = Path(out_dir) if out_dir is not None else ROOT / "chiprun_out" / "lm"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "phase18.json", "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"[lm-train] phase 18: {time.perf_counter() - t_phase:.3f} s; record in {out_dir}",
          flush=True)
    return record


def lm_train_run(torch, cfg, b: int, s: int, seed: int, dev, smi: str, cut: bool,
                 remat_peak: bool, census_trace: bool):
    """One bfloat16 training run of phase 18 (c), with (e) and (f) when
    ``census_trace``: ``LM_TRAIN_WARMUP`` + ``LM_TRAIN_TIMED`` steps on one
    fixed batch."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.train import loss_and_grads, make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_steps = LM_TRAIN_WARMUP + LM_TRAIN_TIMED
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    opt = AdamWConfig(**LM_TRAIN_OPT, total_steps=n_steps, moment_dtype=cfg.opt_state_dtype)
    state = init_adamw(opt, model)
    sync()
    t_init = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    tokens, _prefix, _P = lm_tokens(torch, cfg, b, s, seed, dev)
    batch = {"tokens": tokens}
    step = make_train_step(model, opt)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        model, state, met = step(model, state, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(met["loss"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    losses = [float(x) for x in losses]
    # the loss must fall: below LM_TRAIN_FALL x the first step's within the
    # run. Not "the last below the first": at qwen2.5-14b's width the CLI's
    # warm-up to lr 3e-3 memorizes the fixed batch in two steps and then
    # overshoots, and the JAX reference's loss does the same step for step
    low = min(range(1, n_steps), key=lambda i: losses[i])
    if not all(math.isfinite(x) for x in losses) or \
            not losses[low] < LM_TRAIN_FALL * losses[0]:
        fail(f"lm-train (c) {cfg.name}: losses {losses} are not finite and falling")
    step_ms = sorted(t * 1e3 for t in times[LM_TRAIN_WARMUP:])
    p50 = step_ms[len(step_ms) // 2]
    flops = rl.step_flops(cfg, ShapeConfig("train", s, b, "train"), rl.logical_widths(cfg),
                          b, 1, cfg.n_layers, needed=True)[0]
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    # the update alone: AdamW over one step's gradients, CUDA events
    _loss, grads = loss_and_grads(model, batch, cfg.microbatches)
    upd_bytes = lm_update_bytes(model, state, grads)
    if on_card:
        upd_ms = time_cuda(torch, lambda: adamw_update(opt, model, grads, state),
                           LM_TRAIN_UPDATE_REPS)
    else:
        t0 = time.perf_counter()
        adamw_update(opt, model, grads, state)
        upd_ms = (time.perf_counter() - t0) * 1e3
    del grads
    upd_bound_ms = upd_bytes / PEAK_BYTES * 1e3
    row = {"arch": cfg.name, "layers": cfg.n_layers, "params": params, "batch": b, "seq": s,
           "microbatches": cfg.microbatches, "remat": cfg.remat,
           "moment_dtype": cfg.opt_state_dtype, "init_s": t_init,
           "step_ms": [t * 1e3 for t in times], "step_p50_ms": p50,
           "tokens_per_s": b * s / p50 * 1e3, "flops": flops, "bound_ms": bound_ms,
           "bound_tokens_per_s": b * s / bound_ms * 1e3, "update_ms": upd_ms,
           "update_bytes": upd_bytes, "update_bound_ms": upd_bound_ms, "peak_bytes": peak,
           "losses": losses, "last_below_first": losses[-1] < losses[0]}
    print(f"[lm-train] (c) {cfg.name}{' depth cut to ' + str(cfg.n_layers) + ' layers' if cut else ''}, "
          f"{cfg.param_dtype}, {params / 1e9:.3f} B params, batch {b} x {s}, microbatches "
          f"{cfg.microbatches}, remat {cfg.remat}, moments {cfg.opt_state_dtype}: step p50 "
          f"{p50:.3f} ms over {LM_TRAIN_TIMED} timed steps ({row['tokens_per_s']:.1f} "
          f"tokens/s; bound {bound_ms:.3f} ms = {row['bound_tokens_per_s']:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); update "
          f"{upd_ms:.3f} ms (bound {upd_bound_ms:.3f} ms, {upd_bytes / 1e9:.3f} GB at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s); peak {peak / 2**30:.3f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[low]:.4f} (step {low + 1}) -> {losses[-1]:.4f} "
          f"(step {n_steps}; {' '.join(f'{x:.4f}' for x in losses)}); init {t_init:.3f} s; "
          f"{smi}", flush=True)
    if remat_peak and on_card:
        # peak of one loss and backward at LM_TRAIN_REMAT_BATCH, remat on and off
        peaks = {}
        small = {"tokens": tokens[:LM_TRAIN_REMAT_BATCH]}
        base_cfg = model.cfg
        for remat in (True, False):
            model.cfg = dataclasses.replace(base_cfg, remat=remat, microbatches=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            _l, g = loss_and_grads(model, small)
            sync()
            peaks[remat] = (torch.cuda.max_memory_allocated(), held)
            del g
        model.cfg = base_cfg
        row["remat_peak"] = {"batch": LM_TRAIN_REMAT_BATCH, "on_bytes": peaks[True][0],
                             "off_bytes": peaks[False][0], "held_bytes": peaks[True][1]}
        print(f"[lm-train] (c) {cfg.name}: one loss + backward on {LM_TRAIN_REMAT_BATCH} x "
              f"{s} tokens, peak {peaks[True][0] / 2**30:.3f} GiB with remat, "
              f"{peaks[False][0] / 2**30:.3f} GiB without ({peaks[True][1] / 2**30:.3f} GiB "
              f"of weights and moments held); {smi}", flush=True)
    if census_trace:
        def two_steps():
            for _ in range(LM_TRAIN_CENSUS_STEPS):
                step(model, state, batch)

        row["census"] = lm_census(
            torch, two_steps, on_card, sync,
            ("src/repro_torch/models/", "src/repro_torch/optim/",
             "src/repro_torch/launch/train.py"), f"lm-train (e) {cfg.name}",
            f"{LM_TRAIN_CENSUS_STEPS} train steps")
        if on_card:
            trace_window(torch, lambda: step(model, state, batch), 1,
                         f"lm-train-trace {cfg.name}", top=8,
                         unit=f"train step of {b} x {s} tokens")
    del model, state, tokens, batch
    if on_card:
        torch.cuda.empty_cache()
    return row


def lm_grads_run(torch, cfg, b: int, s: int, seed: int, dev, smi: str):
    """Phase 18 (d): the accumulated gradients over the config's
    microbatches, the clip and the grad norm, without the update (the
    float32 moments of the cut model would not fit beside them)."""
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import clip_by_global_norm

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    params = sum(p.numel() for p in model.parameters())
    largest = max(p.numel() for p in model.parameters())
    tokens, _prefix, _P = lm_tokens(torch, cfg, b, s, seed, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tap = MoETap(model)
    sync()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(model, {"tokens": tokens}, cfg.microbatches)
    grads, norm = clip_by_global_norm(grads, 1.0)
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tap.close()
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not (finite and math.isfinite(float(loss)) and math.isfinite(float(norm))):
        fail(f"lm-train (d) {cfg.name}: non-finite loss, gradients or grad norm")
    kept = routed = 0
    for _module, r in tap.routings(cfg):
        kept += int(r.keep.sum())
        routed += r.keep.numel()
    share = kept / routed if routed else None
    row = {"arch": cfg.name, "layers": cfg.n_layers, "params": params, "largest_leaf": largest,
           "batch": b, "seq": s, "microbatches": cfg.microbatches, "seconds": wall,
           "peak_bytes": peak, "loss": float(loss), "grad_norm": float(norm),
           "kept_share": share, "moe_calls": len(tap.calls)}
    print(f"[lm-train] (d) {cfg.name} depth cut to {cfg.n_layers} layers, bfloat16, "
          f"{params / 1e9:.3f} B params (largest leaf {largest / 1e9:.3f} G), batch {b} x {s} "
          f"in {cfg.microbatches} microbatches, remat {cfg.remat}: accumulated gradients, "
          f"clip and grad norm (no update) in {wall:.3f} s; loss {float(loss):.4f}, grad "
          f"norm {float(norm):.4f}, every gradient finite; kept {share:.4f} of (token, slot) "
          f"pairs over the {len(tap.calls)} MoE calls recorded; peak "
          f"{peak / 2**30:.3f} GiB; {smi}", flush=True)
    del model, grads, tokens
    if on_card:
        torch.cuda.empty_cache()
    return row


# -- phase 19: the LM dry run ---------------------------------------------------


def lm_dryrun_phase(torch, smi: str, device=None, cells=None, checks=LM_DRY_SMALL,
                    census=LM_DRY_CENSUS, grid=None, out_dir=None,
                    repeats: int = LM_DRY_REPEATS):
    """Phase 19: the LM dry run (``repro_torch.launch.dryrun``), device (0,
    0)'s share of each LM cell on the 16x16 grid. (a) One reduced config
    of each family on the 2x2 grid, 1 period, float32 with TF32 off, from
    the same seeded weights: the share's outputs (logits, caches; loss and
    gradients in train) on the card against the CPU's within
    ``LM_DRY_TOL``. (b) ``run_cell`` of every (arch, shape) cell and of
    ``LM_DRY_SERVING`` with serving sharding: the at-rest state at real
    size, the 1- and 2-period shares timed and extrapolated, the update
    (train), every output finite; one line a record with its bound,
    ``nvidia-smi``'s name and power limit. (c) The ``LM_DRY_FULL`` cells
    also at full depth, within ``LM_DRY_FULL_TOL`` of the extrapolation.
    (d) One period's share of each ``census`` cell under phase 16's sync
    census: no sync charged to ``launch/dryrun.py`` or
    ``distributed/sharding.py``. ``device="cpu"`` with small ``cells``
    ((config, shape, serving) triples), ``census`` and a ``grid``
    rehearses on the CPU (no time is measured there)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as dr

    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    out_dir = Path(out_dir) if out_dir is not None else ROOT / "chiprun_out" / "dryrun"
    g22 = ((2, 2), ("data", "model"))
    record = {"device": smi, "card_vs_cpu": [], "cells": [], "census": []}

    # -- (a) the reduced configs' shares, card against CPU ---------------------
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    try:
        for seed, arch in enumerate(LM_DRY_FAMILIES):
            for s, b, kind in checks:
                cfg, shape, grid2, ss = dr.cell_config(
                    get_config(arch).reduced(), ShapeConfig(f"{kind}-b{b}", s, b, kind), grid=g22)
                host = dr.LMShare(cfg, shape, grid2, ss, cfg.period,
                                  torch.Generator().manual_seed(seed))
                err = dr.max_scaled_err(host.to(dev).run(), host.run())
                worst = max(worst, err)
                record["card_vs_cpu"].append({"arch": cfg.name, "shape": shape.name, "err": err})
                if not err <= LM_DRY_TOL:
                    fail(f"lm-dryrun (a) {cfg.name} {shape.name}: the share on {dev} differs "
                         f"from the CPU's by {err} x (1 + |CPU|) > {LM_DRY_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[lm-dryrun] (a) {len(record['card_vs_cpu'])} reduced shares (6 families x "
          f"train, prefill, decode, long decode) on the 2x2 grid, float32: {dev} vs CPU "
          f"max |err| {worst:.3e} x (1 + |CPU|) <= {LM_DRY_TOL}", flush=True)

    # -- (b), (c) every cell ----------------------------------------------------
    if cells is None:
        cells = [(a, s, False) for a, s in dr.all_cells(False)]
        cells += [(a, s, True) for a, s in LM_DRY_SERVING]
    for arch, shape_name, serving in cells:
        name = arch if isinstance(arch, str) else arch.name
        sname = shape_name if isinstance(shape_name, str) else shape_name.name
        full = (name, sname) in LM_DRY_FULL
        r = dr.run_cell(arch, shape_name, False, out_dir=out_dir, force=True,
                        serving_sharding=serving, device=dev,
                        repeats=1 if (name, sname) in LM_DRY_ONE_BATCH else repeats,
                        full_depth=full, grid=grid,
                        graph_ms=0.0 if (name, sname) in LM_DRY_EAGER else dr.GRAPH_MS)
        if not (r["ok"] and r["outputs_finite"]):
            fail(f"lm-dryrun (b) {r['arch']} {r['shape']}: ok {r['ok']} "
                 f"({r.get('error')}), outputs finite {r['outputs_finite']}")
        wire = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in
                         r["collectives_by_kind_extrap"].items() if v)
        ms, warm = r["device_ms_per_period"], r["warmup_ms_per_period"]
        upd = (f"; update {r['update_ms']} ms (bound {r['update_bound_ms']:.4f})"
               if r["kind"] == "train" else "")
        share = (f"{r['bound_ms'] / r['device_ms_extrap']:.4f}" if r["device_ms_extrap"]
                 else "n/a")
        print(f"[lm-dryrun] (b) {r['arch']} {r['shape']} {r['mesh']}: device_ms_extrap "
              f"{r['device_ms_extrap']} ({r['timed']}, median of {r['repeats']} batches: "
              f"1 period {ms['1']}, 2 periods "
              f"{ms['2']}; warm-up calls {warm['1']}, {warm['2']}) beside "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {share} of it reached, "
              f"{r['device_needed_flops_extrap']:.4e} FLOPs needed, "
              f"{r['share_bytes']:.4e} bytes){upd}; state at rest "
              f"{r['device_state_bytes'] / 2**30:.3f} GiB allocated (per chip "
              f"{r['state_bytes_per_chip'] / 2**30:.3f}), share peak "
              f"{(r['share_peak_bytes'] or 0) / 2**30:.3f} GiB, fits_hbm {r['fits_hbm']}; "
              f"wire GiB/step: {wire or 'none'}; {r['run_s']} s; {smi}", flush=True)
        if full and on_card:
            gap = abs(r["device_ms_full"] - r["device_ms_extrap"]) / r["device_ms_full"]
            warm = (f"eager warm-up {r['warmup_ms_full']} ms" if r["warmup_ms_full"]
                    else "warmed up on the capture's side stream")
            print(f"[lm-dryrun] (c) {r['arch']} {r['shape']} at full depth "
                  f"{r['device_ms_full']} ms vs extrapolated {r['device_ms_extrap']} ms "
                  f"({r['timed']}): {gap:.4f} apart; {warm}", flush=True)
            if gap > LM_DRY_FULL_TOL:
                fail(f"lm-dryrun (c) {r['arch']} {r['shape']}: full depth "
                     f"{r['device_ms_full']} ms is {gap:.3f} from the extrapolation")
        record["cells"].append(r)

    # -- (d) the shares under the sync census -----------------------------------
    watched = ("src/repro_torch/launch/dryrun.py", "src/repro_torch/distributed/sharding.py")
    for arch, shape_name in census:
        cfg, shape, grid_c, ss = dr.cell_config(arch, shape_name, grid=grid)
        share = dr.LMShare(cfg, shape, grid_c, ss, cfg.period,
                           torch.Generator(device=dev).manual_seed(0))
        share.run()
        sync()
        record["census"].append(lm_census(
            torch, share.run, on_card, sync, watched,
            f"lm-dryrun (d) {cfg.name} {shape.name}", "one period's share"))
        del share
    if on_card:
        torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "phase19.json", "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"[lm-dryrun] phase 19: {record['seconds']:.3f} s, {len(record['cells'])} cells; "
          f"record in {out_dir}", flush=True)
    return record


def slide_marks(tuples, slide: float):
    """Per sgt, whether a service that has seen ``tuples`` from the start
    expires at it (a slide boundary: ``PersistentQueryService.ingest``'s
    rule)."""
    nxt, marks = slide, []
    for sgt in tuples:
        marks.append(sgt.ts >= nxt)
        while nxt <= sgt.ts:
            nxt += slide
    return marks


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def churn_phase(torch, queries, smi: str, p4, device=None, n_slots: int = 2048):
    """Phase 20: live query churn (benchmarks/fig13_query_churn.py's
    protocol) on phase 4's configuration and stream, through the service:
    late registrations at 1/3 (``q_cap`` grows 13 -> 16 -> 20) and, at
    2/3, two founding queries retired and one more registered into a freed
    lane. Survivors are held to phase 4's run (``p4``, from
    ``phase4_summary``) per event; each late lane to its own
    ``make_churn_oracle`` built on the group's device just before the
    registration, fed the rest of the stream one sgt at a time. Then the
    three RPQ examples'
    ``main``. ``device`` and ``n_slots`` let it rehearse on the CPU (where
    no kernel launches). Returns B1's launches by the churned group."""
    from repro_torch.core.automaton import compile_query
    from repro_torch.core.engine import make_churn_oracle
    from repro_torch.kernels.maxmin import maxmin as b1
    from repro_torch.streaming.service import PersistentQueryService
    from repro_torch.streaming.stream import Stream

    on_card = device is None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    window, slide = 20.0, 2.0
    tuples = p4["tuples"]
    marks = slide_marks(tuples, slide)
    thirds = (len(tuples) // 3, 2 * len(tuples) // 3)
    svc = register_phase4(PersistentQueryService(window=window, slide=slide,
                                                 device=device), queries, n_slots)
    rec = record(svc)
    group = svc._group
    kern = b1.maxmin_matmul_fused
    counts = {"b1": 0, "rounds": 0}

    def on_group(fn, *args, **kw):
        """One call into the churned service: its host-clock seconds
        (synchronised), B1's launches counted from 0 and the group's
        closure rounds."""
        sync()
        kern.launches = 0
        rounds0 = group.executor.rounds_total
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        dt = time.perf_counter() - t0
        counts["b1"] += kern.launches
        counts["rounds"] += group.executor.rounds_total - rounds0
        return out, dt

    late = {}

    def register_late(name: str, expr: str, semantics: str, at: int, expect_lane=None):
        oracle, seed = make_churn_oracle(compile_query(expr), group, window,
                                         group.n_slots, path_semantics=semantics)
        dist0 = tuple(group.batched_arrays.dist.shape)
        initial, dt = on_group(svc.register, name, expr, engine="dense",
                               path_semantics=semantics)
        lane = group.lane_of(name)
        if initial != seed:
            fail(f"churn: {name}'s initial answers ({len(initial)} pairs) != its "
                 f"fresh oracle's seed ({len(seed)})")
        if expect_lane is not None and lane != expect_lane:
            fail(f"churn: {name} took lane {lane}, not the freed lane {expect_lane}")
        late[name] = dict(oracle=oracle, at=at, lane=lane, reg_ms=dt * 1e3,
                          seed=len(seed))
        print(f"[churn] register {name} ({expr}, {semantics}) at sgt {at}: lane "
              f"{lane}, dist {dist0} -> {tuple(group.batched_arrays.dist.shape)}, "
              f"{len(seed)} initial pairs == its fresh oracle's seed; reg_ms "
              f"{dt * 1e3:.3f} (re-pad + seeding closure, host clock, synchronised); "
              f"{smi}", flush=True)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fallbacks, wall = {}, 0.0
    parts = (tuples[:thirds[0]], tuples[thirds[0]:thirds[1]], tuples[thirds[1]:])
    for k, part in enumerate(parts):
        report, dt = on_group(svc.ingest, Stream(part), record_latency=True)
        wall += dt
        fallbacks.update(report.fallbacks)
        if k == 0:
            caps = [group.q_cap]
            for name, (base, sem) in CHURN_LATE.items():
                register_late(name, queries[base], sem, thirds[0])
                caps.append(group.q_cap)
            # on the card Q3's simple lane falls back only near the end (its
            # planted conflict): no lane is free before the growth
            if on_card and tuple(caps) != CHURN_Q_CAPS:
                fail(f"churn: q_cap went {caps}, not {CHURN_Q_CAPS}")
        elif k == 1:
            freed = sorted(group.lane_of(name) for name in CHURN_RETIRE)
            for name in CHURN_RETIRE:
                svc.deregister(name)
                svc.deregister(f"{name}_ref")
            name, base = CHURN_RECLAIM
            register_late(name, queries[base], "arbitrary", thirds[1],
                          expect_lane=freed[0])
            if group.q_cap != caps[-1]:
                fail(f"churn: q_cap {group.q_cap} after the reclaim, not {caps[-1]}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # survivors: unperturbed, per event, against phase 4's run
    survivors = [n for n in p4["results"] if n not in CHURN_RETIRE
                 and n.removesuffix("_ref") not in CHURN_RETIRE]
    logs = dense_logs(group)
    bad = [n for n in p4["logs"] if n in survivors and logs.get(n) != p4["logs"][n]]
    if bad:
        fail(f"churn: survivors' per-event result logs differ from phase 4's for {bad}")
    kept = set(survivors)
    if [e for e in rec["inv"] if e[1] in kept] != [e for e in p4["rec"]["inv"] if e[1] in kept]:
        fail("churn: survivors' per-event deletion invalidations differ from phase 4's")
    bad = [n for n in survivors if svc.results(n) != p4["results"][n]]
    if bad:
        fail(f"churn: survivors' results differ from phase 4's for {bad}")
    if fallbacks != p4["fallbacks"]:
        fail(f"churn: fallbacks {fallbacks} != phase 4's {p4['fallbacks']}")
    for key in ("fallback_at", "fallback_log"):
        if rec[key] != p4["rec"][key]:
            fail(f"churn: the RSPQ fallback ({key}) differs from phase 4's")
    if on_card and (counts["b1"] <= 0 or counts["b1"] != counts["rounds"]):
        fail(f"churn: B1 launches {counts['b1']} != the churned group's closure "
             f"rounds {counts['rounds']}")
    sgts_s = len(tuples) / wall
    lat = sorted(svc.stats["Q1"].latencies_us)
    print(f"[churn] {len(survivors)} survivors' results, per-event result logs and "
          f"invalidations == phase 4's; {sorted(fallbacks)} fell back at the same "
          f"stream time {rec['fallback_at']}; q_cap {group.q_cap}, "
          f"{group.n_queries} live lanes; B1 launches {counts['b1']} == closure "
          f"rounds of the churned group (ingests and seeding closures)", flush=True)
    print(f"[churn] {len(tuples)} sgts in {wall:.3f} s = {sgts_s:.3f} sgts/s, "
          f"dispatch p50 {lat[len(lat) // 2] / 1e3:.3f} ms (phase 4, same run: "
          f"{p4['sgts_s']:.3f} sgts/s, p50 {p4['p50'] / 1e3:.3f} ms); peak device "
          f"memory across the growth {peak} bytes ({peak / 2**30:.3f} GiB); {smi}",
          flush=True)

    # late lanes: each against its fresh oracle, fed the rest of the stream
    oracle_b1 = 0
    for name, lt in late.items():
        oracle, at = lt["oracle"], lt["at"]
        inv = []
        kern.launches = 0
        t0 = time.perf_counter()
        for i in range(at, len(tuples)):
            sgt = tuples[i]
            if marks[i]:
                oracle.expire(sgt.ts)
            if sgt.op == "+":
                oracle.insert(sgt.src, sgt.dst, sgt.label, sgt.ts)
            else:
                out = oracle.delete(sgt.src, sgt.dst, sgt.label, sgt.ts)
                if out:
                    inv.append((sgt.ts, name, frozenset(out)))
        sync()
        dt = time.perf_counter() - t0
        oracle_b1 += kern.launches
        # past the seed (held equal above; the oracle logs it at its
        # float32 clock, the group at its host mirror of that clock)
        got = by_event(group.per_query_log[lt["lane"]][lt["seed"]:])
        if got != by_event(oracle.result_log[lt["seed"]:]):
            fail(f"churn: {name}'s per-event result log differs from its fresh oracle's")
        if [e for e in rec["inv"] if e[1] == name] != inv:
            fail(f"churn: {name}'s per-event invalidations differ from its fresh oracle's")
        if svc.results(name) != oracle.results:
            fail(f"churn: {name}'s results differ from its fresh oracle's")
        print(f"[churn] {name} (lane {lt['lane']}) == its fresh oracle per event over "
              f"sgts {at}..{len(tuples) - 1} ({len(tuples) - at} sgts, "
              f"{len(oracle.results)} result pairs, {len(inv)} invalidating "
              f"deletions; oracle {dt:.3f} s)", flush=True)
        del lt["oracle"], oracle
    ms = {name: round(lt["reg_ms"], 3) for name, lt in late.items()}
    print(f"[churn] reg_ms {ms}; oracles' B1 launches {oracle_b1} (not counted "
          "above)", flush=True)
    del svc, group, late
    if on_card:
        torch.cuda.empty_cache()

    # the RPQ examples, as a user runs them
    argv = [] if on_card else ["--device", str(device)]
    for name in ("quickstart_torch", "streaming_service_torch", "distributed_rpq_torch"):
        t0 = time.perf_counter()
        load_example(name).main(argv)
        sync()
        print(f"[churn] examples/{name}.py main({argv}): {time.perf_counter() - t0:.3f} s",
              flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"[churn] phase 20: {seconds:.3f} s", flush=True)
    return {"b1": counts["b1"], "oracle_b1": oracle_b1, "reg_ms": ms,
            "sgts_s": sgts_s, "peak": peak, "seconds": seconds}


if __name__ == "__main__":
    main()
