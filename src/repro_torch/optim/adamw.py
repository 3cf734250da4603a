"""AdamW with dtype policies, global-norm clipping, and cosine schedule.
The port of ``repro.optim.adamw``.

The state mirrors the parameters: ``m`` and ``v`` are dicts keyed by the
model's parameter names (``"layers.3.attn.wq"``, as
``launch.specs.abstract_params`` names them). ``moment_dtype`` sets their
storage (bf16 for >=100B models, so one pod's HBM holds the whole train
state). The arithmetic is the reference's, step for step: float32 math
for each leaf, the moments stored in ``moment_dtype``, the parameter cast
back to its own dtype. ``torch.optim.AdamW`` differs (decay before the
step, ``sqrt(v)/sqrt(bc2)``, moments in the parameter's dtype), and so
does ``clip_grad_norm_`` (``norm + 1e-6``); neither is used.

``step``, the learning rate and the gradient norm stay 0-d tensors on the
parameters' device: an update makes no host sync. :func:`adamw_update`
writes the parameters, the moments and the step in place under
``no_grad`` (the reference donates its params and state to the jitted
step, so one copy of the state lives at full width); it clips the
gradients in place too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Tensors = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32
    m: Dict[str, torch.Tensor]   # like params
    v: Dict[str, torch.Tensor]   # like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # or "bfloat16"


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]


def named_tensors(params: Union[nn.Module, Tensors]) -> Dict[str, torch.Tensor]:
    """A module's parameters by name, or a mapping of tensors as given."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_adamw(cfg: AdamWConfig, params: Union[nn.Module, Tensors]) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each parameter (a module's,
    by name, or a mapping's), and a step of 0 on the first one's device."""
    params = named_tensors(params)
    md = _mdtype(cfg)
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=md, device=p.device) for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=md, device=p.device) for k, p in params.items()},
    )


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min (float32, on step's device)."""
    step = step.float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum over leaves (in the mapping's order) of each leaf's
    float32 sum of squares."""
    total = None
    for x in tree.values():
        x32 = x.float()
        sq = torch.sum(x32.square_() if x32 is not x else torch.square(x32))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))`` in float32,
    cast back to its dtype, in place. Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Union[nn.Module, Tensors],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step over every parameter, in place: the parameters, the
    moments and the step; the gradients are clipped in place. Returns
    (params by name, the state, {"lr", "grad_norm"} as device scalars)."""
    params = named_tensors(params)
    md = _mdtype(cfg)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    state.step.add_(1)
    lr = lr_schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, state.step.float())
    bc2 = 1 - torch.pow(b2, state.step.float())
    for k, p in params.items():
        m, v = state.m[k], state.v[k]
        g32 = grads[k].float()
        # the reference's expressions, one rounding each, with at most four
        # leaf-sized float32 temporaries (g32, m32, v32 and one product)
        m32 = m.float() * b1
        m32 += g32 * (1 - b1)
        v32 = v.float() * b2
        v32 += torch.square(g32).mul_(1 - b2)
        del g32
        m.copy_(m32)
        v.copy_(v32)
        m32.div_(bc1)                               # mhat
        v32.div_(bc2).sqrt_().add_(cfg.eps)         # sqrt(vhat) + eps
        m32.div_(v32)
        del v32
        p32 = p.float()
        m32 += p32 * cfg.weight_decay               # delta
        m32.mul_(lr).neg_().add_(p32)               # p - lr * delta
        del p32
        p.copy_(m32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
