"""End-to-end driver on the PyTorch port (the paper's deployment kind): a
persistent-query service ingesting a streaming graph with sliding-window
semantics.

* registers a mixed workload (arbitrary + simple path semantics, dense +
  reference engines) over an SO-like stream,
* ingests with eager evaluation / lazy expiration (slide interval beta),
* injects explicit deletions (negative tuples),
* checkpoints engine state mid-stream and proves re-attach works,
* prints per-query throughput/latency/result stats.

Runs on the CUDA card; add ``--device cpu`` to run the kernels' plain
versions on the CPU.

    PYTHONPATH=src python examples/streaming_service_torch.py [--device cpu]
"""
import argparse
import tempfile
import time
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.device import resolve_device
from repro_torch.streaming.generators import so_like, with_deletions
from repro_torch.streaming.service import PersistentQueryService
from repro_torch.streaming.stream import Stream


def _service(device) -> PersistentQueryService:
    svc = PersistentQueryService(window=20.0, slide=2.0, device=device)
    svc.register("notify", "a2q . c2a*", engine="dense", n_slots=96)
    svc.register("notify_simple", "a2q . c2a*", engine="dense",
                 path_semantics="simple", n_slots=96)
    svc.register("reach_ref", "(a2q | c2a)+", engine="reference")
    return svc


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Set[Tuple]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    stream = with_deletions(so_like(n_vertices=48, n_edges=900, seed=42),
                            ratio=0.02, seed=1)
    print(f"stream: {len(stream)} sgts over {stream.span()[1]:.0f}s "
          f"(2% explicit deletions)")

    svc = _service(device)
    tuples = list(stream)
    half = len(tuples) // 2
    t0 = time.perf_counter()
    svc.ingest(Stream(tuples[:half]), record_latency=True)

    # --- mid-stream checkpoint + re-attach (fault tolerance drill) ---------
    with tempfile.TemporaryDirectory() as ckpt_dir:
        svc.snapshot(ckpt_dir, step=half)
        svc2 = _service(device)
        svc2.restore(ckpt_dir)
        assert svc2.results("notify") == svc.results("notify")
        print(f"[ckpt] snapshot + re-attach at sgt {half}: OK "
              f"({len(svc.results('notify'))} results preserved)")

    svc.ingest(Stream(tuples[half:]), record_latency=True)
    wall = time.perf_counter() - t0

    print(f"\ningested {len(tuples)} sgts in {wall:.2f}s "
          f"({len(tuples)/wall:.0f} sgts/s aggregate)")
    for name, st in svc.stats.items():
        print(f"  {name:15s} results={st.results:6d} p99={st.p99_us:8.0f}us "
              f"conflicted={st.conflicted}")
    return {name: svc.results(name) for name in svc.stats}


if __name__ == "__main__":
    main()
