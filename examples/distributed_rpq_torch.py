"""Distributed dense-RPQ evaluation on the PyTorch port: one process over a
``(data, model)`` device grid, lanes over the data axis and the dist's v
axis over the model axis (``MeshExecutor``), held equal to the
single-device engine. On the card the grid spans every visible card when
there are at least two, else eight shards on one card; ``--device cpu``
runs eight shards on the CPU with the kernels' plain versions.

    PYTHONPATH=src python examples/distributed_rpq_torch.py [--device cpu]
"""
import argparse
from typing import Optional, Sequence, Set, Tuple

import torch

from repro_torch.core import compile_query
from repro_torch.core.engine import DenseRPQEngine
from repro_torch.device import resolve_device
from repro_torch.distributed.executor import MeshExecutor
from repro_torch.streaming.generators import so_like

N_SHARDS = 8      # the reference example's (4, 2) grid
MODEL_AXIS = 2


def grid_devices(device: torch.device):
    """Every visible card when there are at least two, else ``N_SHARDS``
    shards on the one device."""
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(device)] * N_SHARDS


def main(argv: Optional[Sequence[str]] = None) -> Set[Tuple[object, object]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    devices = grid_devices(device)
    model_axis = MODEL_AXIS if len(devices) % MODEL_AXIS == 0 else 1
    dfa = compile_query("a2q . c2a*")
    stream = so_like(n_vertices=48, n_edges=800, seed=9)

    # single-device baseline
    base = DenseRPQEngine(dfa, window=30.0, n_slots=64, batch_size=32,
                          device=device)
    for batch in stream.batches(32):
        base.insert_batch([s.as_edge() for s in batch])

    # sharded engine: lanes over the data axis, the dist's v axis and the
    # adjacency's blocks over the model axis
    mesh = MeshExecutor(devices, model_axis=model_axis)
    eng = DenseRPQEngine(dfa, window=30.0, n_slots=64, batch_size=32,
                         executor=mesh)
    for batch in stream.batches(32):
        eng.insert_batch([s.as_edge() for s in batch])

    assert eng.results == base.results
    print(f"devices: {len(devices)}, grid: "
          f"{{'data': {mesh.n_shards}, 'model': {mesh.n_model}}}")
    print(f"results: {len(eng.results)} pairs (sharded == single-device)")
    print("grid:", [[str(d) for d in row] for row in mesh.grid])
    return set(eng.results)


if __name__ == "__main__":
    main()
