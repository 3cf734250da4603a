"""FLOP and byte counts of the LM steps, for their bounds on the card.

One counter serves every LM measurement: the serving and training runs
of the whole model on one card (``chip_smoke.py`` phases 17 and 18, at
:func:`logical_widths`) and the dry run's device shares
(:mod:`repro_torch.launch.dryrun`, at :func:`widths` of the grid). A
count is by :class:`Widths`, the part of each split dimension a program
computes, so one formula covers the whole layer and one device's share.

Two FLOP counts (:func:`forward_flops`):

* **what the step needs** (``needed=True``), which the bounds use:
  causal attention (each query against its own prefix, s(s+1)/2 pairs;
  a decode step against its live cache rows), the SSD recurrence (a
  state update and a read-out a token, 4 h n p), the experts' FFNs on the
  routed (token, slot) pairs, the LM head on the positions read, no
  recompute;
* **what the implementation runs** (``needed=False``), XLA's count of the
  reference's lowered program: every query chunk against the whole
  sequence, the SSD's chunked einsums, the experts at full capacity, the
  LM head on every chunk-padded position, and the remat's recompute
  apart.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

from ..configs import ModelConfig, ShapeConfig
from ..models import layers as L
from ..models.moe import expert_capacity
from ..models.ssd import SSDConfig
from .dryrun_rpq import _round_up
from .specs import DECODE_HEADROOM

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bfloat16 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s
D_CONV = SSDConfig._field_defaults["d_conv"]


class Widths(NamedTuple):
    """What a program computes of each split dimension: the whole layer's
    or one device's share."""
    H: int          # query heads
    KV: int         # kv heads
    f: int          # MLP columns
    E: int          # experts whose FFNs run
    di: int         # SSD inner width (h * head_dim)
    h: int          # SSD heads
    V: int          # vocabulary rows / columns
    dcols: int      # frontend projection columns


def _split(n: int, tp: int) -> int:
    return n // tp if n and n % tp == 0 and n >= tp else n


def widths(cfg: ModelConfig, tp: int, local: bool) -> Widths:
    """The padded widths at tensor-parallel degree ``tp``: the whole
    layer's, or (``local``) device (0, 0)'s block of each dimension split
    over ``model``."""
    H, KV = cfg.padded_heads(tp)
    V = cfg.padded_vocab(tp)
    t = tp if local else 1
    h = _split(cfg.ssm_heads, t) if cfg.ssm_state else 0
    return Widths(H=_split(H, t), KV=_split(KV, t), f=_split(cfg.d_ff, t),
                  E=_split(cfg.n_experts, t), di=h * cfg.ssm_head_dim, h=h,
                  V=_split(V, t), dcols=_split(cfg.d_model, t))


def logical_widths(cfg: ModelConfig) -> Widths:
    """The config's own widths: unpadded heads and vocabulary."""
    h = cfg.ssm_heads if cfg.ssm_state else 0
    return Widths(H=cfg.n_heads, KV=cfg.n_kv_heads, f=cfg.d_ff, E=cfg.n_experts,
                  di=h * cfg.ssm_head_dim, h=h, V=cfg.vocab_size, dcols=cfg.d_model)


def forward_flops(cfg: ModelConfig, shape: ShapeConfig, w: Widths, rows: int,
                  groups: int, n_layers: int, seq_rows: Optional[int] = None,
                  needed: bool = False, pairs: Optional[Sequence[float]] = None
                  ) -> Dict[str, float]:
    """Matmul and attention-contraction FLOPs of one forward call of
    ``rows`` sequences at widths ``w`` (module docstring: ``needed`` picks
    the count), by part: ``layers`` (``n_layers`` of them), ``head`` (the
    LM head), ``frontend``. ``groups``: the MoE dispatch groups (their
    capacity). ``seq_rows``: the cache rows a decode step attends over
    (default: the capacity, ``seq_len + DECODE_HEADROOM``, as run; the
    live ``seq_len + 1`` as needed). ``pairs[i]``: the routed (token,
    slot) pairs the i-th MoE layer's ``w.E`` experts take (default: their
    even share, ``T k w.E / E``)."""
    d, hd, s = cfg.d_model, cfg.head_dim, shape.seq_len
    decode = shape.kind == "decode"
    sq = 1 if decode else s
    T = rows * sq
    P = cfg.prefix_len if cfg.frontend != "none" else 0
    skv = seq_rows if seq_rows is not None else (s + 1 if needed else s + DECODE_HEADROOM)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    layers, moe_i = 0.0, 0
    for i in range(n_layers):
        if cfg.layer_kind(i) == "attn":
            layers += 2 * T * d * (w.H + 2 * w.KV) * hd + 2 * T * w.H * hd * d
            if decode:
                layers += 4 * rows * w.H * hd * skv
            elif needed:
                layers += 4 * rows * w.H * hd * s * (s + 1) / 2
            else:
                layers += 4 * rows * w.H * hd * _round_up(s, cfg.q_chunk) * s
        else:
            layers += 2 * T * d * (2 * w.di + 2 * n + w.h) + 2 * T * w.di * d
            if decode or needed:
                layers += 4 * T * w.h * n * p
            else:
                Q = cfg.ssm_chunk
                S = _round_up(s, Q)
                layers += 2 * rows * S * Q * n + 2 * rows * S * Q * w.h * p
                layers += 4 * rows * S * w.h * n * p
        if cfg.mlp_kind(i) == "moe":
            layers += 2 * T * d * cfg.n_experts                         # the router
            if needed:
                kept = (pairs[moe_i] if pairs is not None
                        else T * cfg.experts_per_token * w.E / cfg.n_experts)
                layers += 2 * 3 * d * cfg.d_ff * kept
            else:
                C = expert_capacity(T // groups, cfg.experts_per_token, cfg.n_experts,
                                    cfg.capacity_factor)
                layers += groups * w.E * C * 2 * 3 * d * cfg.d_ff
            moe_i += 1
        elif cfg.d_ff:
            layers += 2 * T * 3 * d * w.f
    if shape.kind != "train":
        head = 2 * rows * d * w.V                                       # the last position
    elif needed:
        head = 2 * rows * (s - P - 1) * d * w.V
    else:
        head = 2 * rows * _round_up(s - P - 1, max(cfg.q_chunk, 16)) * d * w.V
    frontend = 2 * rows * P * d * w.dcols if P and not decode else 0
    return {"layers": float(layers), "head": float(head), "frontend": float(frontend)}


def step_flops(cfg: ModelConfig, shape: ShapeConfig, w: Widths, rows: int, groups: int,
               n_layers: int, calls: int = 1, seq_rows: Optional[int] = None,
               needed: bool = False, pairs: Optional[Sequence[float]] = None
               ) -> Tuple[float, float]:
    """(FLOPs, recompute FLOPs) of a step of ``calls`` forward calls
    (microbatches): train is forward + backward, 3x (the frontend 2x: its
    input takes no gradient). The recompute, counted as run only, is the
    nested remat's two extra layer forwards and the checkpointed LM-head
    chunks' one."""
    f = forward_flops(cfg, shape, w, rows, groups, n_layers, seq_rows, needed, pairs)
    if shape.kind != "train":
        return sum(f.values()), 0.0
    flops = calls * (3 * f["layers"] + 3 * f["head"] + 2 * f["frontend"])
    if needed:
        return flops, 0.0
    return flops, calls * ((2 * f["layers"] if cfg.remat else 0.0) + f["head"])


def step_bytes(cfg: ModelConfig, kind: str, w: Widths, weights: Mapping[str, int],
               rows: int, s: int, live: Optional[float] = None,
               experts_read: Optional[Sequence[int]] = None, n_layers: int = 0) -> float:
    """Bytes a step of ``rows`` sequences of ``s`` tokens at widths ``w``
    must move, each read or written once: ``weights`` (a parameter's name
    -> the bytes held) read, but of the embedding table only the rows the
    tokens read and of a MoE layer only ``experts_read[i]`` of its ``w.E``
    experts (default: as many as its slots can reach); the tokens read.
    Train adds the gradients written. Prefill writes its caches and the
    last position's float32 logits. Decode reads the ``live`` cache rows
    (default ``s + 1``) and writes one, reads and writes the SSM and conv
    states, and writes the logits. ``n_layers`` defaults to the config's."""
    act = L.DTYPES[cfg.param_dtype].itemsize
    n_layers = n_layers or cfg.n_layers
    T = rows * (1 if kind == "decode" else s)
    moe_layers = [i for i in range(n_layers) if cfg.mlp_kind(i) == "moe"]
    total = float(rows * (1 if kind == "decode" else s) * 4)      # int32 tokens
    for name, nbytes in weights.items():
        if name == "embed.table":
            nbytes = min(nbytes, T * cfg.d_model * act)
        elif ".moe.w_" in name:
            i = moe_layers.index(int(name.split(".")[1]))
            n_read = (experts_read[i] if experts_read is not None
                      else min(w.E, T * cfg.experts_per_token))
            nbytes = nbytes * n_read / w.E
        total += nbytes
    if kind == "train":
        return total + sum(weights.values())
    total += rows * w.V * 4
    live = s + 1 if live is None else live
    ssm = rows * w.h * cfg.ssm_state * cfg.ssm_head_dim * 4
    conv = rows * (D_CONV - 1) * (w.di + 2 * cfg.ssm_state) * act
    for i in range(n_layers):
        if cfg.layer_kind(i) == "attn":
            kv = 2 * rows * w.KV * cfg.head_dim * act
            total += kv * (live + 1) if kind == "decode" else kv * s
        else:
            total += 2 * (ssm + conv) if kind == "decode" else ssm + conv
    return total
