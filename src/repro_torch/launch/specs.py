"""Input stand-ins for every (arch x shape) cell: shapes and dtypes as
tensors on the ``meta`` device, which allocate nothing. The port of
``repro.launch.specs``.

Decode shapes describe ONE new token against a KV/SSM cache of ``seq_len``
(capacity ``seq_len + DECODE_HEADROOM`` so the cache write stays in
bounds).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..configs.base import ShapeConfig
from ..models.transformer import Cache, Model
from ..optim.adamw import AdamWConfig, AdamWState, init_adamw

DECODE_HEADROOM = 512  # keeps cache seq divisible by the batch axes (32-way)
META = torch.device("meta")


def token_specs(model: Model, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    prefix = cfg.prefix_len if cfg.frontend != "none" else 0
    specs = {"tokens": torch.empty((b, s - prefix), dtype=torch.int32, device=META)}
    if prefix:
        specs["prefix_embeds"] = torch.empty((b, prefix, cfg.d_model),
                                             dtype=torch.float32, device=META)
    return specs


def decode_specs(model: Model, shape: ShapeConfig) -> Tuple[torch.Tensor, List[Cache]]:
    b, s = shape.global_batch, shape.seq_len
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    return token, model.init_caches(b, s + DECODE_HEADROOM, device=META)


def abstract_params(model: Model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name (``"layers.3.attn.wq"``), as meta
    tensors of their shapes and dtypes."""
    meta = Model(model.cfg, tp=model.tp, constrain=model.constrain, device=META)
    return {name: p.detach() for name, p in meta.named_parameters()}


def abstract_opt_state(model: Model, opt_cfg: AdamWConfig) -> AdamWState:
    """``init_adamw``'s state for the model, as meta tensors (the moments by
    parameter name)."""
    return init_adamw(opt_cfg, abstract_params(model))
