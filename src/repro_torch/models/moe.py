"""Mixture-of-Experts layer: top-k router, capacity-bounded scatter
dispatch. The port of ``repro.models.moe``.

Expert weight tensors carry a leading E dim. Tokens beyond an expert's
capacity are dropped (they pass through the residual, as in GShard and
Switch).

Where the reference relies on JAX's out-of-bounds modes, this port makes
the out-of-bounds row explicit: a dropped (token, slot) is sent to row
``capacity`` of a ``(E, capacity + 1, d)`` buffer whose last row is cut
off (the reference's ``.at[].add(mode="drop")``), and the gather back
reads a zero row there (its ``.get(mode="fill", fill_value=0)``). Every
index stays on the device: no host sync.

``local_experts=E_l`` runs one expert-parallel shard: the router over all
E experts and the weights of experts ``[0, E_l)`` only. Each group is
routed at the whole layer's capacity, and a slot routed to an expert of
another shard is dropped here as a slot past capacity is (that shard
computes it).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDict, Params, init_device, normal


def init_moe(gen: Optional[torch.Generator], d_model: int, d_ff: int, n_experts: int,
             dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    dev = init_device(gen, device)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "router": normal(gen, (d_model, n_experts), dev) * s_in,
        "w_gate": (normal(gen, (n_experts, d_model, d_ff), dev) * s_in).to(dtype),
        "w_up": (normal(gen, (n_experts, d_model, d_ff), dev) * s_in).to(dtype),
        "w_down": (normal(gen, (n_experts, d_ff, d_model), dev) * s_out).to(dtype),
    }


class Routing(NamedTuple):
    """One dispatch group's routing, leading dims (..., T, k)."""
    probs: torch.Tensor          # (..., T, E) router softmax, float32
    gate_vals: torch.Tensor      # (..., T, k) renormalised gates
    expert_idx: torch.Tensor     # (..., T, k) experts, best first
    pos_in_expert: torch.Tensor  # (..., T, k) queue position in its expert
    keep: torch.Tensor           # (..., T, k) pos_in_expert < capacity
    capacity: int


def expert_capacity(n_tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Slots per expert in a group of ``n_tokens`` (host arithmetic on
    static shapes)."""
    return max(int(math.ceil(capacity_factor * n_tokens * top_k / n_experts)), 1)


def route(params: Params, xt: torch.Tensor, top_k: int,
          capacity_factor: float) -> Routing:
    """Router, top-k, renormalised gates and queue positions of the tokens
    ``xt`` (..., T, d) of one or more dispatch groups.

    The top k come from a stable descending sort: the reference's
    ``lax.top_k`` order (best first, ties to the lower expert). The order
    matters: each slot's queue position is a cumulative count over the
    flat (T*k, E) order, so a different slot order would drop a different
    token at capacity."""
    T = xt.shape[-2]
    E = params["router"].shape[-1]
    logits = xt.float() @ params["router"]                    # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :top_k]
    expert_idx = order.indices[..., :top_k]
    # renormalize the selected gates (Mixtral/DBRX convention)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, -1, keepdim=True), min=1e-9)
    capacity = expert_capacity(T, top_k, E, capacity_factor)
    # position of each (token, slot) within its expert queue
    onehot = F.one_hot(expert_idx, E).to(torch.int32)          # (..., T, k, E)
    flat = onehot.reshape(*onehot.shape[:-3], T * top_k, E)
    pos = torch.cumsum(flat, dim=-2, dtype=torch.int32) - flat  # (..., T*k, E)
    pos_in_expert = torch.sum(pos * flat, dim=-1).reshape(expert_idx.shape)
    return Routing(probs, gate_vals, expert_idx, pos_in_expert,
                   pos_in_expert < capacity, capacity)


def apply_moe(
    params: Params,
    x: torch.Tensor,              # (b, s, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    n_groups: int = 1,
    local_experts: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). Tokens beyond expert capacity are
    dropped (residual passthrough).

    n_groups: GShard-style dispatch groups. Capacity is enforced PER GROUP;
    the groups are a leading batch dimension (the reference's ``vmap``).
    local_experts: the experts ``[0, E_l)`` whose weights ``params`` holds
    (module docstring); None means all of the router's."""
    E = params["router"].shape[-1]
    E_l = E if local_experts is None else local_experts
    if params["w_gate"].shape[0] != E_l or not 0 < E_l <= E:
        raise ValueError(f"expert weights for {params['w_gate'].shape[0]} experts, "
                         f"expected {E_l} of the router's {E}")
    b, s, d = x.shape
    T_all = b * s
    if n_groups > 1:
        if T_all % n_groups:
            raise ValueError(f"{T_all} tokens do not split into {n_groups} groups")
        yg, aux = _moe_group(params, x.reshape(n_groups, T_all // n_groups, d),
                             top_k, capacity_factor, E_l)
        return yg.reshape(b, s, d), torch.mean(aux)
    y, aux = _moe_group(params, x.reshape(T_all, d), top_k, capacity_factor, E_l)
    return y.reshape(b, s, d), aux


def _moe_group(
    params: Params,
    xt: torch.Tensor,             # (..., T, d) tokens of one or more groups
    top_k: int,
    capacity_factor: float,
    E_l: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    *lead, T, d = xt.shape
    G = math.prod(lead)
    E = params["router"].shape[-1]
    r = route(params, xt, top_k, capacity_factor)
    C = r.capacity
    keep, e_flat = r.keep, r.expert_idx.reshape(G, T * top_k)
    if E_l < E:   # another shard's expert: dropped, to expert 0's row C
        keep = keep & (r.expert_idx < E_l)
        e_flat = torch.where(e_flat < E_l, e_flat, 0)

    # scatter tokens into (G, E_l, C+1, d) buffers; row C takes the drops
    p_flat = torch.where(keep, r.pos_in_expert, C).reshape(G, T * top_k)
    g_flat = torch.arange(G, device=xt.device)[:, None]
    rows = ((g_flat * E_l + e_flat) * (C + 1) + p_flat).reshape(-1)
    src = torch.repeat_interleave(xt.reshape(G, T, d), top_k, dim=1,
                                  output_size=T * top_k).reshape(-1, d)
    buf = torch.zeros((G * E_l * (C + 1), d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, rows, src)
    buf = buf.reshape(G, E_l, C + 1, d)[:, :, :C]

    # expert FFN: (E, C, d) x (E, d, f) batched matmuls
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    y_e = torch.einsum("gecf,efd->gecd", h, params["w_down"])  # (G, E, C, d)

    # gather back (a zero row at C) and combine with gates
    y_e = F.pad(y_e, (0, 0, 0, 1)).reshape(G * E_l * (C + 1), d)
    gathered = y_e[rows].reshape(G, T * top_k, d)
    gathered = gathered * (r.gate_vals.reshape(G, -1, 1).to(xt.dtype) *
                           keep.reshape(G, -1, 1).to(xt.dtype))
    y = torch.sum(gathered.reshape(G, T, top_k, d), dim=2).reshape(xt.shape)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    f = torch.mean(torch.sum(F.one_hot(r.expert_idx, E).float(), dim=-2), dim=-2)
    p_mean = torch.mean(r.probs, dim=-2)
    aux = E * torch.sum(f * p_mean, dim=-1)
    return y, aux


class MoE(ParamDict):
    def forward(self, x: torch.Tensor, **kw):
        return apply_moe(self, x, **kw)
