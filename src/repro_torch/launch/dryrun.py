"""The LM cells on the production grid — the counterpart of
``repro.launch.dryrun``.

A cell is one config (``repro_torch.configs``) x one shape (``SHAPES``:
``train_4k``, ``prefill_32k``, ``decode_32k``, and ``long_500k`` for the
long-context archs) x one grid (:func:`~repro_torch.launch.mesh.
make_production_grid`: 16 x 16, or 2 x 16 x 16). The reference lowers the
whole-grid step and reads XLA's cost and memory analyses. Here no
compiler sees the grid, so each cell does two things on one device,
device (0, 0), from a ``torch.Generator`` seeded by ``--seed``:

* **State at rest.** It allocates that device's block of the whole
  cell's state at real size (``repro_torch.distributed.sharding``'s
  specs): every parameter; for train the AdamW moments in the config's
  ``opt_state_dtype``; for decode the KV, SSM and conv cache blocks at
  ``seq_len + DECODE_HEADROOM``.
* **Timed shares.** It times the device's compute share of 1 and of 2
  periods of layers with CUDA events (:func:`time_shares`: a warm-up call
  of each depth, then batches of calls interleaved across the depths)
  and extrapolates to the config's ``n_periods`` as the reference
  extrapolates XLA's costs: ``t(n) = base + n * per_period``. A share
  (:class:`ShareModel`) is the port's decoder on the blocks FSDP gathers
  for device (0, 0), the first block of every dimension split over
  ``model``: H/tp query and KV/tp kv heads (the padded counts), d_ff/tp
  MLP columns, the SSD heads over ``model`` as the ``ssm_heads`` tag puts
  them (z and x by heads, B and C whole), the router whole and E/tp
  experts at the capacity of the reference's ``moe_groups``, V/tp rows of
  the embedding and columns of the LM head, and the tokens of the
  ``hidden`` tag's batch block (b/data, or each microbatch's block in
  training). Train runs ``loss_and_grads`` with the config's
  ``microbatches`` and remat, and the AdamW update is timed once over the
  device's at-rest parameter and moment blocks; prefill runs
  ``Model.prefill``; decode runs ``Model.decode_step`` on the first
  periods' cache blocks.

Each collective is stood in and its partners' contribution counts as
zero: the FSDP all-gather (the share holds the gathered blocks), the
gradient reduce-scatter, the TP all-reduces after ``wo``, ``w_down`` and
``w_out``, the gated norm's sum of squares over ``d_inner`` (a share
divides its own by the whole width), the vocab-parallel embedding sum and
log-sum-exp, the frontend projection's all-gather (zero columns), the MoE
all-to-alls (``apply_moe(local_experts=E/tp)``: a slot routed to another
device's expert is dropped) and
the long-context decode's softmax combine over sequence shards (the
share attends over its own cache rows; the new token's row, which lives
on another shard, is written into its last row instead). So on weights
whose other model peers' blocks are zero the share equals the unsharded
model, which the tests check on the CPU.

The record keeps the reference's keys where they mean the same thing:
``arch``, ``shape``, ``mesh``, ``chips``, ``kind``, ``seq_sharded``,
``params_logical``/``active``/``padded``, ``state_bytes_per_chip`` (the
tree's bytes over the chips), ``memory.activation_bytes_analytic``,
``peak_bytes_per_chip`` (state plus that bound), ``ok``/``error`` (state
alone over the card's memory), ``global_flops_extrap``,
``device_flops_extrap``, ``collective_wire_bytes_extrap``,
``collectives_by_kind_extrap`` and ``per_period``. Of these the FLOPs are
:mod:`~repro_torch.launch.roofline`'s count as the implementation runs
it, XLA's count of the reference's program (padded heads, every query
chunk against the whole sequence, experts at full capacity; train is
forward plus backward, 3x, the frontend projection 2x), without
recompute, which is ``remat_flops_extrap`` (the nested remat's two extra
forwards of each layer, the checkpointed LM-head chunks' one). Beside
them ``device_needed_flops_extrap`` is the count of what device (0, 0)'s
step needs (causal attention, the SSD recurrence, the even share of the
routed pairs, no recompute), which its bound uses. The collectives are a model
of the layout with the reference's ring formulas (all-reduce
``2 size (g-1)/g``, all-gather, reduce-scatter and all-to-all ``size
(g-1)/g``), wire bytes per device and step by kind:

    all-gather      the FSDP parameter blocks, once per pass (train: a
                    forward and a backward pass per microbatch); the
                    frontend projection's output over ``model``
    reduce-scatter  the FSDP-sharded gradients over the data axes, once
                    per microbatch
    all-reduce      the gradients of the parameters the data axes
                    replicate; the TP sums of (tokens, d) after ``wo``,
                    ``w_down``, ``w_out`` and the MoE combine and of the
                    vocab-parallel embedding (forward, and the column-
                    parallel inputs' in backward); the gated norm's and
                    the LM head's (tokens,) float32 sums; the long decode's
                    softmax combine over the sequence shards
    all-to-all      the MoE dispatch and combine, (G_l, E, C, d) each

It adds, from the run: ``device_ms_per_period`` (1 and 2 periods),
``device_ms_extrap``, ``timed`` (``eager``, or ``cuda_graph`` where the
host's enqueue paces much of a share's eager time: :data:`GRAPH_MS`),
``warmup_ms_per_period`` (each depth's first, eager call),
``update_ms`` (train), ``device_state_bytes`` (the
blocks allocated), ``share_peak_bytes`` (``max_memory_allocated`` after a
reset, less what the process held before the cell), ``bound_ms`` and
``bound_by`` (the larger of ``device_needed_flops_extrap`` over 989
TFLOP/s, the H100 SXM's dense bfloat16 peak, and ``share_bytes`` over
3.35 TB/s: :func:`~repro_torch.launch.roofline.step_bytes` of the
share's weight blocks), ``update_bound_ms``, ``fits_hbm``
(against the card's own ``total_memory``), ``device`` (``nvidia-smi``'s
name and power limit) and ``run_s``. On the CPU (``--device cpu``, the
tests) the device fields are None: not measured.

The reference's ``lower_s``, ``compile_s``, XLA's memory analysis
(``argument``/``output``/``temp``/``alias`` bytes), its post-SPMD
``device_bytes`` and the HLO scrape (``n_collectives``,
``collectives_*_rolled``) have no counterpart: no compiler lowers the
grid's program here, so there is no compile time, no buffer assignment
and no HLO to read. This module never sets ``XLA_FLAGS``.

Records go to ``chiprun_out/dryrun/`` at the repo root (git-ignored), one
JSON file per cell, reused unless ``--force``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m
        --shape decode_32k [--mesh pod|multipod|both] [--all] [--force]
        [--serving-sharding] [--device cuda|cpu] [--seed S] [--repeats R]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import gc
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..configs import ARCH_NAMES, SHAPES, ModelConfig, ShapeConfig, get_config, shape_applicable
from ..device import DeviceLike, resolve_device
from ..distributed.sharding import (
    Grid,
    ShareDims,
    axes_size,
    axis_sizes,
    batch_axes,
    block_shape,
    cache_shardings,
    constrain_spec,
    fsdp_axes,
    make_constrain,
    params_shardings,
)
from ..models import layers as L
from ..models.moe import MoE, expert_capacity
from ..models.params import param_name
from ..models.transformer import _GROUP_CLASSES, Cache, Model
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw
from .dryrun_rpq import _event_ms, _smi, _time_ms
from .mesh import make_production_grid
from .roofline import PEAK_BF16_FLOPS, PEAK_BYTES, Widths, step_bytes, step_flops, widths
from .specs import DECODE_HEADROOM, decode_specs
from .train import loss_and_grads

RESULTS_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun"

Ranges = Optional[Tuple[Tuple[int, int], ...]]   # a dimension's kept index ranges


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------


def build_cell(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
               multi_pod: bool = False, n_layers: int = 0, grid: Optional[Grid] = None):
    """(cfg, shape, grid, model, seq_sharded), the reference's: ``moe_groups``
    from the batch shards (halved until the tokens split into them),
    ``seq_sharded = global_batch < data``, and the model on the ``meta``
    device at the grid's tensor-parallel degree with :func:`make_constrain`.
    ``arch``/``shape_name`` may be a config/shape and ``grid`` another grid
    (the tests' small ones)."""
    cfg, shape, grid, seq_sharded = cell_config(arch, shape_name, multi_pod, n_layers, grid)
    model = Model(cfg, tp=axis_sizes(grid)["model"],
                  constrain=make_constrain(grid, seq_sharded), device="meta")
    return cfg, shape, grid, model, seq_sharded


def cell_config(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
                multi_pod: bool = False, n_layers: int = 0, grid: Optional[Grid] = None):
    """:func:`build_cell` without the model: (cfg, shape, grid, seq_sharded)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    grid = grid or make_production_grid(multi_pod=multi_pod)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sizes = axis_sizes(grid)
    if cfg.n_experts:
        shards = sizes["data"] * sizes.get("pod", 1)
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        groups = shards
        while tokens % groups != 0 or groups > tokens:
            groups //= 2
        cfg = dataclasses.replace(cfg, moe_groups=max(groups, 1))
    return cfg, shape, grid, shape.global_batch < sizes["data"]


@functools.lru_cache(maxsize=64)
def _meta_model(cfg: ModelConfig, tp: int) -> Model:
    """The model on the ``meta`` device (shapes only; the MoE groups do not
    change a shape, so one serves every cell of a config)."""
    return Model(cfg, tp=tp, device="meta")


def meta_model(cfg: ModelConfig, tp: int) -> Model:
    return _meta_model(dataclasses.replace(cfg, moe_groups=1), tp)


def opt_shardings(p_shard: Mapping[str, tuple]) -> AdamWState:
    """Optimizer moments share the parameter specs; the step is replicated."""
    return AdamWState(step=(), m=dict(p_shard), v=dict(p_shard))


def analytic_activation_bytes(cfg: ModelConfig, shape: ShapeConfig, grid: Grid,
                              model=None) -> float:
    """Per-chip activation bound under the nested-remat schedule, the
    reference's formula (bf16 activations = 2 B, f32 transients = 4 B):
      boundaries : n_periods x (b_l*s*d) x 2          (outer remat residuals)
      layer_in   : period x (b_l*s*d) x 2             (inner remat residuals)
      cotangent  : 3 x (b_l*s*d) x 4
      work       : max over layer kinds of its transient set
      head/loss  : (b_l*q_chunk*V_l) x 4 x 2
    """
    sizes = axis_sizes(grid)
    tp = sizes["model"]
    bs = sizes["data"] * sizes.get("pod", 1)
    b, sq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        sq = 1
    b_l = max(b // bs, 1)
    if b < bs:  # seq sharded
        sq = max(sq // bs, 1)
        b_l = b
    d = cfg.d_model
    hidden = b_l * sq * d
    n_periods = cfg.n_layers // cfg.period
    V_l = cfg.padded_vocab(tp) // tp
    H, KV = cfg.padded_heads(tp)
    h_l = max(H // tp, 1) if H else 0
    work = 0.0
    for o in range(cfg.period):
        w = 0.0
        if cfg.layer_kind(o) == "attn":
            kv_len = shape.seq_len if shape.kind == "decode" else sq
            w += b_l * h_l * cfg.q_chunk * kv_len * 4          # score chunk
            w += 3 * b_l * sq * h_l * cfg.head_dim * 2         # qkv slices
        else:
            sh_l = max(cfg.ssm_heads // tp, 1)
            w += 3 * b_l * sq * cfg.ssm_chunk * sh_l * 4       # intra-chunk L/W/dW
            w += b_l * sq * (2 * cfg.d_inner // tp + 2 * cfg.ssm_state) * 2
        if cfg.mlp_kind(o) == "moe":
            E_l = max(cfg.n_experts // tp, 1)
            T_g = b_l * sq if shape.kind != "train" else (b * shape.seq_len) // max(cfg.moe_groups, 1)
            C = max(int(math.ceil(cfg.capacity_factor * T_g * cfg.experts_per_token / cfg.n_experts)), 1)
            w += 2 * E_l * C * (d + cfg.d_ff) * 2
        elif cfg.d_ff:
            w += 2 * b_l * sq * (cfg.d_ff // tp if cfg.d_ff % tp == 0 else cfg.d_ff) * 2
        work = max(work, w)
    M = max(cfg.microbatches, 1) if shape.kind == "train" else 1
    total = (n_periods * hidden * 2 + cfg.period * hidden * 2
             + 3 * hidden * 4 + work + b_l * cfg.q_chunk * V_l * 4 * 2) / M
    if shape.kind == "train" and M > 1:
        total += _grad_buffer_bytes(cfg, grid)  # bf16 accumulation buffer
    if shape.kind != "train":
        # no backward: boundaries/cotangents absent; keep layer transit + head
        total = cfg.period * hidden * 2 + work + b_l * max(sq, 1) * V_l * 4
    return float(total)


def _grad_buffer_bytes(cfg: ModelConfig, grid: Grid) -> float:
    chips = math.prod(grid[0])
    return 2.0 * cfg.param_count(logical=False, tp=axis_sizes(grid)["model"]) / chips


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a dict, list, tuple or named tuple (meta
    tensors allocate nothing and count their shapes)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


# ---------------------------------------------------------------------------
# device (0, 0)'s share: widths, blocks and the share model
# ---------------------------------------------------------------------------


def share_ranges(name: str, shape: Sequence[int], cfg: ModelConfig, w: Widths) -> List[Ranges]:
    """Device (0, 0)'s compute block of a parameter or cache tensor (the
    full layer's ``shape``), as each dimension's kept index ranges (None:
    whole): the model-axis blocks FSDP gathers. A cache's batch and
    sequence blocks are its spec's (``sharding.cache_shardings``)."""
    leaf = name.split(".")[-1]
    nd = len(shape)
    full: List[Ranges] = [None] * nd
    di, n = cfg.d_inner, cfg.ssm_state

    def at(dim: int, *ranges: Tuple[int, int]) -> List[Ranges]:
        out = list(full)
        out[dim] = tuple(ranges)
        return out

    hd = cfg.head_dim
    if leaf == "table":
        return at(0, (0, w.V))
    if name.startswith("lm_head"):
        return at(1, (0, w.V))
    if name.startswith("frontend_proj"):
        return at(1, (0, w.dcols))
    if leaf in ("k", "v"):                            # caches (b, S, KV, hd)
        return at(2, (0, w.KV))
    if ".attn." in name:
        cols = {"wq": w.H, "bq": w.H, "wk": w.KV, "bk": w.KV, "wv": w.KV, "bv": w.KV,
                "wo": w.H}[leaf] * hd
        return at(1 if leaf in ("wq", "wk", "wv") else 0, (0, cols))
    if ".moe." in name:
        return full if leaf == "router" else at(0, (0, w.E))
    if ".mlp." in name:
        return at(1 if leaf in ("w_gate", "w_up") else 0, (0, w.f))
    xbc = ((0, w.di), (di, di + 2 * n))              # x by heads, B and C whole
    if leaf == "w_in":
        return at(1, (0, w.di), (di, di + w.di), (2 * di, 2 * di + 2 * n),
                  (2 * di + 2 * n, 2 * di + 2 * n + w.h))
    if leaf in ("conv_w", "conv_b", "conv"):
        return at(nd - 1, *xbc)
    if leaf in ("A_log", "dt_bias", "D"):
        return at(0, (0, w.h))
    if leaf == "ssm":
        return at(1, (0, w.h))
    if leaf in ("norm_scale", "w_out"):
        return at(0, (0, w.di))
    return full                                        # norms, cache lengths


def ranges_shape(shape: Sequence[int], ranges: Sequence[Ranges]) -> Tuple[int, ...]:
    return tuple(dim if r is None else sum(b - a for a, b in r)
                 for dim, r in zip(shape, ranges))


def take(t: torch.Tensor, ranges: Sequence[Ranges]) -> torch.Tensor:
    """The block of ``t`` that ``ranges`` keep (a copy where a dimension
    keeps more than one range)."""
    for dim, r in enumerate(ranges):
        if r is None:
            continue
        parts = [t.narrow(dim, a, b - a) for a, b in r]
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return t


def vocab_parallel_xent_chunk(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """One chunk of the fused LM-head cross-entropy on device (0, 0)'s
    vocabulary rows ``[0, V_l)`` (``w``: (d, V_l)): the log-sum-exp over its
    own logits (the max and sum all-reduces over ``model`` stood in), the
    target's logit where the target is one of its rows, else zero (the
    target all-reduce stood in)."""
    logits = (x @ w).float()                                   # (b, chunk, V_l)
    lse = torch.logsumexp(logits, dim=-1)
    local = targets < w.shape[-1]
    tgt = torch.gather(logits, -1, torch.where(local, targets, 0)[..., None].long())[..., 0]
    return torch.sum((lse - tgt * local) * mask)


class ShareEmbedding(L.ParamDict):
    """The vocab-parallel embedding on rows ``[0, V_l)``: a token outside
    them reads zero (the sum over ``model`` stood in)."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self["table"]
        local = tokens < table.shape[0]
        x = table[torch.where(local, tokens, 0)]
        return x * local[..., None].to(x.dtype)


class ShareMoE(MoE):
    """The MoE layer on the router whole and experts ``[0, E_l)``: every
    group routed over all E at the whole layer's capacity, a slot routed
    to another device's expert dropped (the all-to-alls stood in)."""

    def forward(self, x: torch.Tensor, **kw):
        return super().forward(x, local_experts=self["w_gate"].shape[0], **kw)


_SHARE_CLASSES = {**_GROUP_CLASSES, "embed": ShareEmbedding, "moe": ShareMoE}


class ShareModel(Model):
    """Device (0, 0)'s share of a cell's model (module docstring): the
    port's :class:`Model` whose parameter groups hold the gathered
    model-axis blocks (:func:`share_ranges`), with the local head, SSD and
    vocabulary widths, the vocab-parallel embedding and cross-entropy, and
    a constrain hook that checks every tagged activation's block shape.
    ``cfg.moe_groups`` is the device's own dispatch groups and
    ``batch`` the global batch of one call. Built uninitialised on
    ``device``; :meth:`randomize` or :meth:`load` fills it."""

    xent_chunk = staticmethod(vocab_parallel_xent_chunk)

    def __init__(self, cfg: ModelConfig, grid: Grid, seq_sharded: bool, batch: int,
                 device: DeviceLike = None):
        tp = axis_sizes(grid)["model"]
        vocab = cfg.padded_vocab(tp)
        super().__init__(cfg, tp=tp, device="meta", constrain=make_constrain(
            grid, seq_sharded, ShareDims(batch=batch, ssm_heads=cfg.ssm_heads, vocab=vocab)))
        full_groups = list(self.param_groups(None, "meta"))   # the whole layer's
        self.local = widths(cfg, tp, local=True)
        self.H, self.KV, self.V = self.local.H, self.local.KV, self.local.V
        if self.ssd_cfg is not None:
            self.ssd_cfg = self.ssd_cfg._replace(d_inner=self.local.di, n_heads=self.local.h,
                                                 norm_width=cfg.d_inner)
        dev = resolve_device(device)
        #: every parameter's full name, shape and kept ranges
        self.blocks: Dict[str, Tuple[Tuple[int, ...], List[Ranges]]] = {}
        for path, values in full_groups:
            local = {}
            for leaf, t in values.items():
                name = param_name(path, leaf)
                ranges = share_ranges(name, t.shape, cfg, self.local)
                self.blocks[name] = (tuple(t.shape), ranges)
                local[leaf] = torch.empty(ranges_shape(t.shape, ranges), dtype=t.dtype,
                                          device=dev)
            parent = self if len(path) == 1 else self.layers[path[1]]
            parent.add_module(path[-1], _SHARE_CLASSES[path[-1]](local))

    @torch.no_grad()
    def randomize(self, gen: torch.Generator) -> "ShareModel":
        """Random weights from ``gen`` (on the share's device): normal
        matrices scaled by their fan-in, norm scales and ``D`` one, the SSD
        decay rates the reference's ``log(linspace(1, 16, h))`` of the
        whole layer, biases zero."""
        for name, p in self.named_parameters():
            leaf = name.split(".")[-1]
            if leaf in ("scale", "norm_scale", "D"):
                p.fill_(1.0)
            elif leaf in ("dt_bias", "conv_b", "bq", "bk", "bv"):
                p.zero_()
            elif leaf == "A_log":
                p.copy_(torch.log(torch.linspace(1.0, 16.0, self.cfg.ssm_heads,
                                                 device=p.device))[: p.shape[0]])
            else:
                fan_in = p.shape[-2] if p.dim() >= 2 and leaf != "table" else 1
                p.normal_(0.0, 0.02 if leaf == "table" else fan_in ** -0.5, generator=gen)
        return self

    @torch.no_grad()
    def load(self, named: Mapping[str, torch.Tensor]) -> "ShareModel":
        """Device (0, 0)'s blocks of the full layer's weights (by name, as
        ``Model.named_parameters`` gives them)."""
        for name, p in self.named_parameters():
            p.copy_(take(named[name], self.blocks[name][1]))
        return self

    def _embed_inputs(self, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.embed(tokens)
        if self.cfg.frontend != "none":
            if prefix_embeds is None:
                raise ValueError("the stub frontend needs prefix_embeds")
            pre = prefix_embeds.to(self.dtype) @ self.frontend_proj["w"]
            # the all-gather over model stood in: the peers' columns zero
            pre = F.pad(pre, (0, self.cfg.d_model - pre.shape[-1]))
            x = torch.cat([pre, x], dim=1)
        return self.constrain(x, "hidden")


def local_batch(shape: ShapeConfig, cfg: ModelConfig, grid: Grid,
                seq_sharded: bool) -> Tuple[int, int]:
    """(global batch of one call, device (0, 0)'s rows of it): the
    ``hidden`` tag's block of one microbatch in training, of the batch
    otherwise."""
    M = max(cfg.microbatches, 1) if shape.kind == "train" else 1
    b_call = shape.global_batch // M
    s = 1 if shape.kind == "decode" else shape.seq_len
    spec = constrain_spec(grid, seq_sharded, (b_call, s, cfg.d_model), "hidden")
    return b_call, block_shape((b_call, s, cfg.d_model), spec, grid)[0]


def local_groups(cfg: ModelConfig, b_call: int, b_l: int) -> int:
    """Device (0, 0)'s MoE dispatch groups: ``moe_groups`` split as the
    tokens are. The local tokens must be whole groups."""
    shards = b_call // b_l
    if cfg.moe_groups % shards:
        raise ValueError(f"{cfg.moe_groups} MoE groups do not split over {shards} "
                         "batch shards")
    return max(cfg.moe_groups // shards, 1)


def share_cfg(cfg: ModelConfig, shape: ShapeConfig, grid: Grid, seq_sharded: bool,
              n_layers: int) -> Tuple[ModelConfig, int, int]:
    """(the share's config at ``n_layers``, global batch of a call, local
    rows of it): the config with the device's own MoE groups."""
    b_call, b_l = local_batch(shape, cfg, grid, seq_sharded)
    groups = local_groups(cfg, b_call, b_l) if cfg.n_experts else cfg.moe_groups
    return dataclasses.replace(cfg, n_layers=n_layers, moe_groups=groups), b_call, b_l


# -- the timed shares (the roots R1 scopes) --------------------------------------


def prefill_share(share: ShareModel, batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, List[Cache]]:
    """Device (0, 0)'s prefill: its V_l logits of the last position and its
    caches."""
    return share.prefill(batch["tokens"], batch.get("prefix_embeds"))


def decode_share(share: ShareModel, token: torch.Tensor, caches: List[Cache]
                 ) -> Tuple[torch.Tensor, List[Cache]]:
    """Device (0, 0)'s decode step on its cache blocks (k and v in place)."""
    return share.decode_step(token, caches)


def train_share(share: ShareModel, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Device (0, 0)'s loss and gradients over its local batch, in the
    config's microbatches, with its remat."""
    return loss_and_grads(share, dict(batch), share.cfg.microbatches)


# ---------------------------------------------------------------------------
# analytic FLOPs, bytes and collectives
# ---------------------------------------------------------------------------


def _ring(kind: str, size: float, g: int) -> float:
    if g <= 1:
        return 0.0
    return (2.0 if kind == "all-reduce" else 1.0) * size * (g - 1) / g


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, grid: Grid, seq_sharded: bool,
                     serving: bool, n_layers: int) -> Dict[str, float]:
    """The collective model (module docstring): wire bytes per device and
    step, by kind, of device (0, 0)'s share at ``n_layers``."""
    sizes = axis_sizes(grid)
    tp, fs = sizes["model"], fsdp_axes(grid)
    g_fs = axes_size(grid, fs)
    train = shape.kind == "train"
    M = max(cfg.microbatches, 1) if train else 1
    passes = 2 if train else 1
    scfg, _b_call, rows = share_cfg(cfg, shape, grid, seq_sharded, n_layers)
    meta = meta_model(scfg, tp)
    act = L.DTYPES[cfg.param_dtype].itemsize
    specs = params_shardings(dict(meta.named_parameters()), grid,
                             serving=serving and not train)
    w = widths(cfg, tp, local=True)
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0, "all-to-all": 0.0}
    for name, p in meta.named_parameters():
        gathered = math.prod(ranges_shape(p.shape, share_ranges(name, p.shape, cfg, w)))
        nbytes = gathered * p.element_size()
        on_fs = any(a is not None and set((a,) if isinstance(a, str) else a) & set(fs)
                    for a in specs[name])
        if on_fs:
            out["all-gather"] += M * passes * _ring("all-gather", nbytes, g_fs)
            if train:
                out["reduce-scatter"] += M * _ring("reduce-scatter", nbytes, g_fs)
        elif train:
            out["all-reduce"] += M * _ring("all-reduce", nbytes, g_fs)
    sq = 1 if shape.kind == "decode" else shape.seq_len
    T = rows * sq
    hidden = T * cfg.d_model * act
    tp_sums = 1.0                                     # the embedding's
    norms = 0
    for i in range(n_layers):
        if cfg.layer_kind(i) == "attn":
            tp_sums += 1.0                            # after wo (heads split)
        elif w.h < cfg.ssm_heads:
            tp_sums += 1.0                            # after w_out
            norms += 1                                # the gated norm's squares
        if cfg.mlp_kind(i) == "moe":
            tp_sums += w.E < cfg.n_experts            # the combine (experts split)
            C = expert_capacity(T // scfg.moe_groups, cfg.experts_per_token,
                                cfg.n_experts, cfg.capacity_factor)
            buf = scfg.moe_groups * cfg.n_experts * C * cfg.d_model * act
            out["all-to-all"] += M * passes * 2 * _ring("all-to-all", buf, tp)
        elif cfg.d_ff:
            tp_sums += w.f < cfg.d_ff                 # after w_down (columns split)
    out["all-reduce"] += M * passes * tp_sums * _ring("all-reduce", hidden, tp)
    out["all-reduce"] += M * passes * norms * _ring("all-reduce", T * 4.0, tp)
    if train:   # the LM head: max, sum and target logit; its input's gradient
        out["all-reduce"] += M * (3 * _ring("all-reduce", T * 4.0, tp)
                                  + _ring("all-reduce", hidden, tp))
    if cfg.frontend != "none" and shape.kind != "decode":
        pre = rows * cfg.prefix_len * cfg.d_model * act
        out["all-gather"] += M * _ring("all-gather", pre, tp)
        if train:
            out["reduce-scatter"] += M * _ring("reduce-scatter", pre, tp)
    if seq_sharded and shape.kind == "decode":
        n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(n_layers))
        part = rows * w.H * (cfg.head_dim + 2) * 4.0
        out["all-reduce"] += n_attn * _ring("all-reduce", part, axes_size(grid, batch_axes(grid)))
    return out


# ---------------------------------------------------------------------------
# the plan (analytic, no device)
# ---------------------------------------------------------------------------


def _seq_block(shape: ShapeConfig, grid: Grid, seq_sharded: bool) -> Optional[int]:
    """Device (0, 0)'s cache rows of a sequence-sharded decode, else None."""
    if not (seq_sharded and shape.kind == "decode"):
        return None
    return (shape.seq_len + DECODE_HEADROOM) // axes_size(grid, batch_axes(grid))


def _device_flops(cfg, shape, grid, seq_sharded, n_layers, local: bool, needed: bool = False):
    """(FLOPs, recompute) of the whole step (``local`` False) or of device
    (0, 0)'s share, as run or (``needed``) as needed: the share's decode
    attends over its own block, of which the rows below ``seq_len + 1``
    are live."""
    tp = axis_sizes(grid)["model"]
    scfg, b_call, b_l = share_cfg(cfg, shape, grid, seq_sharded, n_layers)
    M = max(cfg.microbatches, 1) if shape.kind == "train" else 1
    if local:
        rows, groups, w = b_l, scfg.moe_groups, widths(cfg, tp, local=True)
        seq_rows = _seq_block(shape, grid, seq_sharded)
        if needed and seq_rows is not None:
            seq_rows = min(seq_rows, shape.seq_len + 1)
    else:
        rows, groups, w, seq_rows = b_call, cfg.moe_groups, widths(cfg, tp, local=False), None
    return step_flops(scfg, shape, w, rows, groups, n_layers, calls=M, seq_rows=seq_rows,
                      needed=needed)


def cell_meta(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
              multi_pod: bool = False, serving_sharding: bool = False,
              grid: Optional[Grid] = None) -> Dict[str, Any]:
    """A cell's meta and memory fields, the reference's (``lower_cell``'s
    ``meta``, ``memory.activation_bytes_analytic`` and the peak), with the
    cell's ``moe_groups``, microbatches and device (0, 0)'s batch."""
    cfg, shape, grid, seq_sharded = cell_config(arch, shape_name, multi_pod, grid=grid)
    chips = math.prod(grid[0])
    tp = axis_sizes(grid)["model"]
    model = meta_model(cfg, tp)
    p_abs = dict(model.named_parameters())
    state = _tree_bytes(p_abs)
    if shape.kind == "train":
        state += _tree_bytes(init_adamw(AdamWConfig(moment_dtype=cfg.opt_state_dtype), p_abs))
    elif shape.kind == "decode":
        state += _tree_bytes(decode_specs(model, shape)[1])
    # the reference's run_cell prices activations on the registry's config,
    # whose moe_groups is 1, not the cell's
    act = analytic_activation_bytes(get_config(arch) if isinstance(arch, str) else arch,
                                    shape, grid, model)
    b_call, b_l = local_batch(shape, cfg, grid, seq_sharded)
    tag = f"{cfg.name}-servshard" if serving_sharding else cfg.name
    return {
        "arch": tag, "shape": shape.name,
        "mesh": "x".join(str(n) for n in grid[0]),
        "chips": chips,
        "kind": shape.kind,
        "seq_sharded": seq_sharded,
        "params_logical": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "params_padded": cfg.param_count(logical=False, tp=tp),
        "state_bytes_per_chip": state / chips,
        "moe_groups": cfg.moe_groups,
        "microbatches": max(cfg.microbatches, 1) if shape.kind == "train" else 1,
        "batch_per_call": b_call,
        "local_batch_per_call": b_l,
        "memory": {"activation_bytes_analytic": act},
        "peak_bytes_per_chip": state / chips + act,
    }


def plan_cell(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
              multi_pod: bool = False, serving_sharding: bool = False,
              grid: Optional[Grid] = None) -> Dict[str, Any]:
    """A cell's analytic record (no device): :func:`cell_meta` and the
    ``*_extrap`` FLOPs and collectives (module docstring) from 1 and 2
    periods, extrapolated as the reference extrapolates."""
    meta = cell_meta(arch, shape_name, multi_pod, serving_sharding, grid)
    cfg, shape, grid, seq_sharded = cell_config(arch, shape_name, multi_pod, grid=grid)
    n_periods = cfg.n_layers // cfg.period
    per_n = {}
    for npd in (1, 2):
        nl = npd * cfg.period
        g_flops, g_remat = _device_flops(cfg, shape, grid, seq_sharded, nl, local=False)
        d_flops, d_remat = _device_flops(cfg, shape, grid, seq_sharded, nl, local=True)
        needed, _ = _device_flops(cfg, shape, grid, seq_sharded, nl, local=True, needed=True)
        wire = collective_bytes(cfg, shape, grid, seq_sharded, serving_sharding, nl)
        per_n[npd] = {"global_flops": g_flops, "global_remat_flops": g_remat,
                      "flops": d_flops, "remat_flops": d_remat, "needed_flops": needed,
                      "by_kind": wire, "wire": sum(wire.values())}
    keys = ("flops", "remat_flops", "needed_flops", "global_flops", "global_remat_flops",
            "wire")
    per = {k: per_n[2][k] - per_n[1][k] for k in keys}
    total = {k: per_n[1][k] - per[k] + n_periods * per[k] for k in keys}
    by_kind = {k: per_n[1]["by_kind"][k] + (n_periods - 1)
               * (per_n[2]["by_kind"][k] - per_n[1]["by_kind"][k]) for k in per_n[1]["by_kind"]}
    return {
        **meta,
        "global_flops_extrap": total["global_flops"],
        "global_remat_flops_extrap": total["global_remat_flops"],
        "device_flops_extrap": total["flops"],
        "remat_flops_extrap": total["remat_flops"],
        "device_needed_flops_extrap": total["needed_flops"],
        "collective_wire_bytes_extrap": total["wire"],
        "collectives_by_kind_extrap": by_kind,
        "per_period": per,
    }


# ---------------------------------------------------------------------------
# the run on a device
# ---------------------------------------------------------------------------


def _normal(shape, dtype, gen: torch.Generator, std: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    return t.normal_(0.0, std, generator=gen)


def at_rest_state(model: Model, shape: ShapeConfig, grid: Grid, seq_sharded: bool,
                  serving: bool, gen: torch.Generator) -> Dict[str, Any]:
    """Device (0, 0)'s at-rest blocks of the cell's whole state, random
    from ``gen`` on its device: ``params`` by name, for train ``m`` and
    ``v``, for decode ``caches`` (one dict a layer; ``len`` holds
    ``seq_len``)."""
    cfg = model.cfg
    specs = params_shardings(dict(model.named_parameters()), grid, serving=serving)
    state: Dict[str, Any] = {"params": {}}
    for name, p in model.named_parameters():
        state["params"][name] = _normal(block_shape(p.shape, specs[name], grid), p.dtype,
                                        gen, 0.02)
    if shape.kind == "train":
        md = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.opt_state_dtype]
        state["m"] = {k: _normal(t.shape, md, gen, 1e-3) for k, t in state["params"].items()}
        state["v"] = {k: _normal(t.shape, md, gen, 1e-3).square_()
                      for k, t in state["params"].items()}
    if shape.kind == "decode":
        _token, caches = decode_specs(model, shape)
        cspecs = cache_shardings(grid, caches, seq_sharded)
        state["caches"] = []
        for layer, spec in zip(caches, cspecs):
            blk = {}
            for name, t in layer.items():
                bs = block_shape(t.shape, spec[name], grid)
                blk[name] = (torch.full(bs, shape.seq_len, dtype=t.dtype, device=gen.device)
                             if name == "len" else _normal(bs, t.dtype, gen, 1.0))
            state["caches"].append(blk)
    return state


class LMShare:
    """Device (0, 0)'s share of a cell at ``n_layers``: the share model
    (random from ``gen``) and its inputs (random tokens and prefix
    embeddings; for decode the first layers' cache blocks of ``state`` and
    random conv states of the local channels, or random caches without
    ``state``). ``run()`` executes it.

    The tokens are drawn from the device's own vocabulary rows ``[0,
    V_l)``. With the embedding's sum over ``model`` stood in, a token
    outside them would read a zero row, which no real step holds; the RMS
    norm's gain on such a row reaches ``1/sqrt(eps)`` and a deep share's
    bfloat16 backward overflows (smollm-360m's at 32 layers). The work is
    the same for any token."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, grid: Grid, seq_sharded: bool,
                 n_layers: int, gen: torch.Generator, state: Optional[Dict[str, Any]] = None):
        dev = gen.device
        scfg, b_call, b_l = share_cfg(cfg, shape, grid, seq_sharded, n_layers)
        self.kind = shape.kind
        self.model = ShareModel(scfg, grid, seq_sharded, b_call, device=dev).randomize(gen)
        M = max(cfg.microbatches, 1) if shape.kind == "train" else 1
        rows = M * b_l
        P = cfg.prefix_len if cfg.frontend != "none" else 0
        s = 1 if shape.kind == "decode" else shape.seq_len - P
        self.batch = {"tokens": torch.randint(0, min(cfg.vocab_size, self.model.local.V),
                                              (rows, s), generator=gen, device=dev,
                                              dtype=torch.int32)}
        if P and shape.kind != "decode":
            self.batch["prefix_embeds"] = _normal((rows, P, cfg.d_model), torch.float32, gen, 1.0)
        self.caches: List[Cache] = []
        if shape.kind == "decode":
            w = self.model.local
            full = decode_specs(meta_model(scfg, self.model.tp), shape)[1]
            specs = cache_shardings(grid, full, seq_sharded)
            for i, (layer, spec) in enumerate(zip(full, specs)):
                blk = {}
                for name, t in layer.items():
                    rest = block_shape(t.shape, spec[name], grid)
                    if name == "len":   # replicated at rest; the share's rows
                        blk[name] = torch.full((b_l,), shape.seq_len, dtype=t.dtype, device=dev)
                    elif state is not None and name != "conv":
                        blk[name] = state["caches"][i][name]
                    else:
                        want = rest if name != "conv" else \
                            rest[:2] + ranges_shape(t.shape, share_ranges(name, t.shape, cfg, w))[2:]
                        blk[name] = _normal(want, t.dtype, gen, 1.0)
                self.caches.append(blk)

    def to(self, device: DeviceLike) -> "LMShare":
        """A copy of the share (weights and inputs) on ``device``."""
        dev = torch.device(device)
        other = copy.copy(self)
        other.model = copy.deepcopy(self.model).to(dev)
        other.batch = {k: t.to(dev) for k, t in self.batch.items()}
        other.caches = [{k: t.to(dev) for k, t in c.items()} for c in self.caches]
        return other

    def run(self):
        if self.kind == "train":
            return train_share(self.model, self.batch)
        if self.kind == "prefill":
            return prefill_share(self.model, self.batch)
        return decode_share(self.model, self.batch["tokens"], self.caches)


def _all_finite(out: Any) -> bool:
    flags = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                flags.append(torch.isfinite(x).all())
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    return bool(torch.stack(flags).all()) if flags else True


def max_scaled_err(got: Any, want: Any) -> float:
    """The largest ``max |got - want| / (1 + max |want|)`` over the
    floating tensors of two outputs of the same structure (a share's
    logits, caches, loss or gradients)."""
    if isinstance(want, torch.Tensor):
        if not want.is_floating_point():
            return 0.0 if torch.equal(got.cpu(), want.cpu()) else math.inf
        g, w = got.detach().float().cpu(), want.detach().float().cpu()
        if g.shape != w.shape:
            return math.inf
        return float((g - w).abs().max() / (1.0 + w.abs().max())) if w.numel() else 0.0
    if isinstance(want, Mapping):
        if set(got) != set(want):
            return math.inf
        return max((max_scaled_err(got[k], want[k]) for k in want), default=0.0)
    return max((max_scaled_err(g, w) for g, w in zip(got, want)), default=0.0)


#: How :func:`time_shares` times a cell's shares. The 1- and 2-period
#: shares' first calls are their warm-ups (allocator growth, library
#: handles): eager, outputs checked finite, time kept apart. Where a
#: period's warm-up took less than GRAPH_MS (the least of the 1-period
#: share's and half the 2-period share's: the cell's first call also pays
#: one-time costs), the host's enqueue (a decode step's ~100 operations a
#: layer, a train step's thousands over its microbatches) paces much of a
#: share's eager time, which is then neither the device's time nor linear
#: in the depth (qwen2.5-14b's train_4k, timed eagerly at ~0.3-0.6 s a
#: period, extrapolated 24% above its full depth): every share is then
#: captured in a CUDA graph, after a call on a side stream that warms a
#: deeper share up, and its replays are timed: the first replay (which
#: uploads the graph) untimed, a second one sizing the batches. Longer
#: shares hide the enqueue and run eagerly, a deeper one after its own
#: warm-up (their graphs' memory pools would also crowd the card: jamba's
#: train share peaks at ~47 GiB). Either way each share is timed in ``repeats``
#: batches interleaved across the depths, a batch about TIMED_MS of calls
#: (at least one), and the median batch is kept; the garbage collector is
#: off meanwhile (as ``timeit`` keeps it).
GRAPH_MS = 500.0
TIMED_MS = 100.0


def _graphed(fn: Callable[[], Any]) -> Tuple[Callable[[], None], Any]:
    """(the replay of ``fn`` captured in a CUDA graph, the output of the
    call on a side stream before the capture, which warms the graph's
    memory pool up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay, out


def time_shares(fns: Mapping[int, Callable[[], Any]], dev: torch.device, repeats: int,
                graph_ms: float = GRAPH_MS
                ) -> Tuple[bool, Dict[int, Optional[float]], Dict[int, Optional[float]], str]:
    """(whether every share's first call gave finite floating outputs, each
    share's ms as described above with ``graph_ms`` for GRAPH_MS, each
    eager warm-up's ms (None for a deeper share warmed up on the side
    stream), ``"cuda_graph"`` or ``"eager"``); ``fns`` is keyed by the
    number of periods, 1 and 2 among them. Off the card each runs once and
    the times are None."""
    on_card = dev.type == "cuda"
    warm: Dict[int, Optional[float]] = {}

    def warm_up(key: int) -> bool:
        out: List[Any] = []
        warm[key] = _event_ms(lambda: out.append(fns[key]()), 1) if on_card else None
        if not out:
            out.append(fns[key]())
        return _all_finite(out.pop())

    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        if not on_card:
            finite = all([warm_up(key) for key in fns])
            return finite, dict(warm), warm, "eager"
        finite = all([warm_up(1), warm_up(2)])
        per = min(warm[1], warm[2] / 2)
        graphed = per < graph_ms
        timed: Dict[int, Callable[[], Any]] = {}
        est: Dict[int, float] = {}
        for key, fn in fns.items():
            if graphed:
                timed[key], out = _graphed(fn)
                if key not in warm:
                    warm[key] = None
                    finite = _all_finite(out) and finite
                del out
                timed[key]()
                est[key] = _event_ms(timed[key], 1)
            else:
                if key not in warm:
                    finite = warm_up(key) and finite
                timed[key] = fn
                est[key] = warm[key]
        batches: Dict[int, List[float]] = {key: [] for key in fns}
        for _ in range(repeats):
            for key, times in batches.items():
                n = min(max(1, math.ceil(TIMED_MS / max(est[key], 1e-3))), 100)
                times.append(_event_ms(timed[key], n))
        ms = {key: statistics.median(t) for key, t in batches.items()}
        return finite, ms, warm, "cuda_graph" if graphed else "eager"
    finally:
        if collecting:
            gc.enable()


def share_bytes(cfg: ModelConfig, shape: ShapeConfig, grid: Grid, seq_sharded: bool) -> float:
    """Bytes device (0, 0)'s share of the whole step must move:
    :func:`~repro_torch.launch.roofline.step_bytes` of its gathered
    weight blocks, its rows (every microbatch's in train) and, in a
    sequence-sharded decode, the live rows of its own cache block."""
    tp = axis_sizes(grid)["model"]
    scfg, _b_call, b_l = share_cfg(cfg, shape, grid, seq_sharded, cfg.n_layers)
    M = max(cfg.microbatches, 1) if shape.kind == "train" else 1
    w = widths(cfg, tp, local=True)
    weights = {n: math.prod(ranges_shape(p.shape, share_ranges(n, p.shape, cfg, w)))
               * p.element_size() for n, p in meta_model(scfg, tp).named_parameters()}
    block = _seq_block(shape, grid, seq_sharded)
    live = None if block is None else min(block, shape.seq_len + 1)
    return step_bytes(cfg, shape.kind, w, weights, M * b_l, shape.seq_len, live)


def run_cell(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
             multi_pod: bool = False, out_dir: Optional[Path] = None, force: bool = False,
             serving_sharding: bool = False, device: DeviceLike = None, seed: int = 0,
             repeats: int = 2, full_depth: bool = False, grid: Optional[Grid] = None,
             graph_ms: float = GRAPH_MS) -> Dict[str, Any]:
    """One cell's record: :func:`plan_cell`'s fields and the run's (cached
    as JSON under ``out_dir``, reused unless ``force``). ``device=None``
    means the card and raises without one. ``full_depth`` also times the
    share at the config's whole depth (``device_ms_full``); ``graph_ms``
    stands for GRAPH_MS (0: every share eager)."""
    out_dir = Path(out_dir or RESULTS_DIR)
    cfg0 = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_tag = "multipod" if multi_pod else "pod"
    tag = f"{cfg0.name}-servshard" if serving_sharding else cfg0.name
    path = out_dir / f"{tag}__{shape.name}__{mesh_tag}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t0 = time.monotonic()
    result = plan_cell(cfg0, shape, multi_pod, serving_sharding, grid=grid)
    cfg, shape, grid, seq_sharded = cell_config(cfg0, shape, multi_pod, grid=grid)
    model = meta_model(cfg, axis_sizes(grid)["model"])
    serving = serving_sharding and shape.kind != "train"
    hbm = torch.cuda.get_device_properties(dev).total_memory if on_card else None
    result.update({"ok": True, "device": _smi() if on_card else str(dev), "repeats": repeats,
                   "fits_hbm": None if hbm is None else bool(result["peak_bytes_per_chip"] <= hbm)})
    if hbm is not None and result["state_bytes_per_chip"] > hbm:
        result.update({"ok": False, "error": "state exceeds HBM"})
        out_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))
        return result
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = at_rest_state(model, shape, grid, seq_sharded, serving, gen)
    result["device_state_bytes"] = _tree_bytes(state)
    n_periods = cfg.n_layers // cfg.period
    depths = [1, 2] + ([n_periods] if full_depth else [])
    shares = {npd: LMShare(cfg, shape, grid, seq_sharded, npd * cfg.period, gen, state)
              for npd in depths}
    finite, ms, warm, timed = time_shares({npd: sh.run for npd, sh in shares.items()},
                                          dev, repeats, graph_ms)
    del shares
    per = None if ms[1] is None else ms[2] - ms[1]
    result["per_period"]["device_ms"] = per
    result.update({
        "n_periods": n_periods,
        "device_ms_per_period": {"1": ms[1], "2": ms[2]},
        "device_ms_extrap": None if per is None else ms[1] - per + n_periods * per,
        "device_ms_full": ms.get(n_periods) if full_depth else None,
        "timed": timed,
        "warmup_ms_per_period": {"1": warm[1], "2": warm[2]},
        "warmup_ms_full": warm.get(n_periods) if full_depth else None,
        "outputs_finite": finite,
    })
    if shape.kind == "train":
        grads = {k: _normal(p.shape, torch.bfloat16 if cfg.microbatches > 1 else p.dtype,
                            gen, 1e-3) for k, p in state["params"].items()}
        opt = AdamWState(torch.zeros((), dtype=torch.int32, device=dev), state["m"], state["v"])
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
        result["update_ms"] = _time_ms(
            lambda: adamw_update(opt_cfg, state["params"], grads, opt), dev, 3)
        moved = sum(p.numel() * (2 * p.element_size() + grads[k].element_size()
                                 + 2 * state["m"][k].element_size()
                                 + 2 * state["v"][k].element_size())
                    for k, p in state["params"].items())
        result["update_bound_ms"] = moved / PEAK_BYTES * 1e3
        del grads, opt
    nbytes = share_bytes(cfg, shape, grid, seq_sharded)
    t_ops = result["device_needed_flops_extrap"] / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    result.update({"share_bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "share_peak_bytes": (torch.cuda.max_memory_allocated(dev) - held
                                        if on_card else None)})
    del state
    result["run_s"] = round(time.monotonic() - t0, 3)
    out_dir.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return result


def all_cells(multi_pod: bool) -> List[Tuple[str, str]]:
    """Every (arch, shape) cell of a grid: 10 configs x 3 shapes, and
    ``long_500k`` for the long-context archs (32 cells)."""
    return [(arch, name) for arch in ARCH_NAMES for name, shape in SHAPES.items()
            if shape_applicable(get_config(arch), shape)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--serving-sharding", action="store_true",
                    help="replicate params over data axes for serve cells")
    ap.add_argument("--device", default=None,
                    help="the card (default; raises without one) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out-dir", default=None, help=f"default {RESULTS_DIR}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    cells = []
    for mp in meshes:
        if args.all:
            cells += [(a, s, mp) for a, s in all_cells(mp)]
        else:
            cells.append((args.arch, args.shape, mp))
    failures = 0
    for arch, shape_name, mp in cells:
        tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
        try:
            r = run_cell(arch, shape_name, mp, out_dir=args.out_dir, force=args.force,
                         serving_sharding=args.serving_sharding, device=dev,
                         seed=args.seed, repeats=args.repeats)
            print(f"[{'ok' if r['ok'] else 'FAIL'}] {tag}: device_ms_extrap "
                  f"{r.get('device_ms_extrap')}, bound {r.get('bound_ms')} ms "
                  f"({r.get('bound_by')}), state {r['state_bytes_per_chip'] / 2**30:.3f} "
                  f"GiB/chip, fits_hbm={r['fits_hbm']}, wire "
                  f"{r['collective_wire_bytes_extrap'] / 2**30:.3f} GiB/step; "
                  f"{r['device']}", flush=True)
            if not r["ok"]:
                failures += 1
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
