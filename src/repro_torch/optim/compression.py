"""Int8 error-feedback gradient compression for the data-parallel
all-reduce. The port of ``repro.optim.compression``.

Before the all-reduce, gradients are quantized to int8 with a per-tensor
scale; the quantization residual is carried in an error-feedback buffer
and added back next step (EF-SGD / 1-bit Adam lineage), preserving
convergence while cutting the all-reduce's bytes 4x against float32.

Gradients are dicts of tensors (the optimiser's layout). The reference's
``compressed_psum`` runs inside ``shard_map`` over a mesh axis; the port's
is one process over the replicas' gradient dicts, as the port's mesh
executor is one process over a device list: each replica compresses with
its own state, and the dequantized contributions are summed on the first
replica's device and divided by the replica count.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


class EFState(NamedTuple):
    residual: Dict[str, torch.Tensor]   # like grads (float32)


def init_ef(params: Tensors) -> EFState:
    return EFState(residual={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for k, p in params.items()})


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress(grads: Tensors, ef: EFState,
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], EFState]:
    """Returns (int8 q by name, float32 scales by name, new state). The
    residual is what int8 could not represent; it re-enters next step
    (error feedback)."""
    qs, scales, residual = {}, {}, {}
    for k, g in grads.items():
        x = g.float() + ef.residual[k]
        q, s = _quantize(x)
        qs[k], scales[k] = q, s
        residual[k] = x - _dequantize(q, s)
    return qs, scales, EFState(residual=residual)


def decompress(qs: Tensors, scales: Tensors) -> Dict[str, torch.Tensor]:
    return {k: _dequantize(q, scales[k]) for k, q in qs.items()}


def compressed_psum(grads: Sequence[Tensors], efs: Sequence[EFState],
                    ) -> Tuple[Dict[str, torch.Tensor], List[EFState]]:
    """The error-feedback int8 all-reduce over ``len(grads)`` replicas, one
    gradient dict and one :class:`EFState` each (on any devices). Each
    replica compresses with its own state; the dequantized contributions
    are summed in replica order on the first replica's device and divided
    by the replica count. Returns (the mean by name, the new states)."""
    if len(grads) != len(efs) or not grads:
        raise ValueError(f"{len(grads)} gradient dicts for {len(efs)} states")
    new_efs, summed = [], None
    for g, ef in zip(grads, efs):
        qs, scales, new_ef = compress(g, ef)
        new_efs.append(new_ef)
        deq = decompress(qs, scales)
        if summed is None:
            summed = deq
            dev = next(iter(deq.values())).device
        else:
            summed = {k: summed[k] + d.to(dev) for k, d in deq.items()}
    n = float(len(grads))   # the reference's psum of ones: exact in float32
    return {k: s / n for k, s in summed.items()}, new_efs
