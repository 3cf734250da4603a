"""Model assembly for every assigned architecture family. The port of
``repro.models.transformer``.

One generic decoder covering:
  dense        (qwen*, smollm)                attn + SwiGLU
  moe          (llama4-scout, dbrx)           attn + top-k MoE
  ssm          (mamba2)                       SSD mixer only
  hybrid       (jamba)                        1:7 attn:SSD interleave, MoE/2
  vlm / audio  (paligemma, musicgen)          stub prefix embeddings + decoder

:class:`Model` is an ``nn.Module``. Its layers sit in an ``nn.ModuleList``,
one :class:`Block` a layer, and every pass runs them in a Python loop: the
reference's ``(n_periods,)`` parameter stacks and its ``lax.scan`` over
periods have no counterpart here (``repro_torch.models.params`` maps one
layout onto the other). Serving caches are a list with one dict a layer.
The serving entry points run without autograd; ``forward`` and ``loss``
keep it. Where ``cfg.remat`` is set and autograd records, a train-mode
pass checkpoints each period of layers and each layer inside it, as the
reference's nested ``jax.checkpoint`` does; the fused LM-head
cross-entropy checkpoints each chunk.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import layers as L
from .moe import MoE, init_moe
from .ssd import SSD, SSDConfig, init_ssd, init_ssd_cache

Constrain = Callable[[torch.Tensor, str], torch.Tensor]
Cache = Dict[str, torch.Tensor]


def _identity_constrain(x: torch.Tensor, _tag: str) -> torch.Tensor:
    return x


#: the module that holds each kind of parameter group
_GROUP_CLASSES = {"ln1": L.RMSNorm, "ln2": L.RMSNorm, "final_norm": L.RMSNorm,
                  "attn": L.Attention, "ssd": SSD, "mlp": L.MLP, "moe": MoE,
                  "embed": L.Embedding, "lm_head": L.LMHead,
                  "frontend_proj": L.ParamDict}


class Block(nn.Module):
    """One decoder layer: norm, mixer (attention or SSD), residual, then
    norm, MLP or MoE, residual. Its parameter groups are attributes named
    as the reference's layer dict names them (``ln1``, ``attn`` | ``ssd``,
    ``ln2``, ``mlp`` | ``moe``)."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind   # attn | ssm

    def forward(self, model: "Model", x: torch.Tensor, cache: Optional[Cache],
                mode: str, positions: Optional[torch.Tensor], max_len: int,
                ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
        """``mode`` is train | prefill | decode. Returns (x, the layer's new
        cache or None in train mode, MoE aux)."""
        cfg = model.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = self.ln1(x, cfg.norm_eps)
        new_cache: Optional[Cache] = None
        if self.kind == "attn":
            att_cache = None
            if mode == "decode":
                att_cache = (cache["k"], cache["v"], cache["len"])
            y, att_cache = self.attn(
                h, n_heads=model.H, n_kv=model.KV, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
                positions=positions, cache=att_cache)
            if mode != "train":
                k, v, ln = att_cache
                if mode == "prefill" and k.shape[1] < max_len:
                    pad = max_len - k.shape[1]
                    k = F.pad(k, (0, 0, 0, 0, 0, pad))
                    v = F.pad(v, (0, 0, 0, 0, 0, pad))
                new_cache = {"k": k, "v": v, "len": ln}
        else:
            ssd_cache = None
            if mode == "decode":
                ssd_cache = (cache["conv"], cache["ssm"])
            y, ssd_cache = self.ssd(model.ssd_cfg, h, cache=ssd_cache,
                                    decode=(mode == "decode"),
                                    constrain=model.constrain)
            if mode != "train":
                new_cache = {"conv": ssd_cache[0], "ssm": ssd_cache[1]}
        x = model.constrain(x + y, "hidden")
        if hasattr(self, "ln2"):
            h = self.ln2(x, cfg.norm_eps)
            if hasattr(self, "moe"):
                y, aux = self.moe(h, top_k=cfg.experts_per_token,
                                  capacity_factor=cfg.capacity_factor,
                                  n_groups=cfg.moe_groups)
            else:
                y = self.mlp(h)
            x = model.constrain(x + y, "hidden")
        return x, new_cache, aux


class Model(nn.Module):
    """cfg + tensor-parallel degree -> init / forward / loss / serve.

    Built with uninitialised parameters on ``device`` (``None``: the card;
    ``"meta"``: shapes and dtypes only); :meth:`init` fills them from a
    seeded ``torch.Generator`` on the same device, or
    ``repro_torch.models.params.params_from_reference`` loads the JAX
    package's. ``tp`` pads the head counts and the vocabulary as the
    reference pads them; ``constrain(x, tag)`` is the layout hook a
    launcher may set (identity by default)."""

    #: one chunk of the fused LM-head cross-entropy, ``(w, x, targets,
    #: mask) -> summed loss``; None is this module's ``_xent_chunk`` (a
    #: vocabulary-parallel head sets its own)
    xent_chunk = None

    def __init__(self, cfg: ModelConfig, tp: int = 1,
                 constrain: Constrain = _identity_constrain,
                 device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.H, self.KV = cfg.padded_heads(tp)
        self.V = cfg.padded_vocab(tp)
        self.dtype = L.DTYPES[cfg.param_dtype]
        self.period = cfg.period
        self.n_periods = cfg.n_layers // cfg.period
        self.constrain = constrain
        self.ssd_cfg = SSDConfig(
            d_model=cfg.d_model,
            d_inner=cfg.d_inner,
            n_heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim,
            d_state=cfg.ssm_state,
            chunk=cfg.ssm_chunk,
        ) if cfg.ssm_state else None
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        self.layers = nn.ModuleList(Block(cfg.layer_kind(i)) for i in range(cfg.n_layers))
        for path, values in self.param_groups(None, dev):
            parent = self if len(path) == 1 else self.layers[path[1]]
            parent.add_module(path[-1], _GROUP_CLASSES[path[-1]](values))

    # -- init ------------------------------------------------------------------

    def param_groups(self, gen: Optional[torch.Generator], device=None,
                     ) -> Iterator[Tuple[tuple, Dict[str, torch.Tensor]]]:
        """(path, tensors) of every parameter group, in a fixed order: path
        ``("embed",)`` or ``("layers", i, "attn")``. From ``gen`` (on its
        device), or uninitialised on ``device`` when ``gen`` is None."""
        cfg, dt = self.cfg, self.dtype
        dev = gen.device if gen is not None else torch.device(device)
        kw = dict(dtype=dt, device=dev)
        yield ("embed",), L.init_embedding(gen, self.V, cfg.d_model, **kw)
        yield ("final_norm",), L.init_rmsnorm(cfg.d_model, **kw)
        yield ("lm_head",), L.init_lm_head(gen, cfg.d_model, self.V, **kw)
        for i in range(cfg.n_layers):
            yield ("layers", i, "ln1"), L.init_rmsnorm(cfg.d_model, **kw)
            if cfg.layer_kind(i) == "attn":
                yield ("layers", i, "attn"), L.init_attention(
                    gen, cfg.d_model, self.H, self.KV, cfg.head_dim,
                    qkv_bias=cfg.qkv_bias, n_heads_logical=cfg.n_heads,
                    n_kv_logical=cfg.n_kv_heads, **kw)
            else:
                yield ("layers", i, "ssd"), init_ssd(gen, self.ssd_cfg, **kw)
            if cfg.d_ff > 0 or cfg.mlp_kind(i) == "moe":
                yield ("layers", i, "ln2"), L.init_rmsnorm(cfg.d_model, **kw)
                if cfg.mlp_kind(i) == "moe":
                    yield ("layers", i, "moe"), init_moe(
                        gen, cfg.d_model, cfg.d_ff, cfg.n_experts, **kw)
                else:
                    yield ("layers", i, "mlp"), L.init_mlp(gen, cfg.d_model, cfg.d_ff, **kw)
        if cfg.frontend != "none":
            # stub frontend projection: maps precomputed modality embeddings
            # (already d_model-sized in the stub) into the decoder space
            w = L.normal(gen, (cfg.d_model, cfg.d_model), dev) / math.sqrt(cfg.d_model)
            yield ("frontend_proj",), {"w": w.to(dt)}

    def group(self, path: tuple) -> L.ParamDict:
        """The module of one parameter group, by its :meth:`param_groups` path."""
        parent = self if len(path) == 1 else self.layers[path[1]]
        return getattr(parent, path[-1])

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter from ``generator``, one group at a time (the
        draws are the port's own; they do not reproduce the reference's
        ``jax.random`` values). Returns the model."""
        for path, values in self.param_groups(generator):
            self.group(path).fill_(values)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- layers ----------------------------------------------------------------

    def _run_layers(self, x: torch.Tensor, caches: Optional[List[Cache]], mode: str,
                    positions: Optional[torch.Tensor], max_len: int = 0,
                    ) -> Tuple[torch.Tensor, Optional[List[Cache]], torch.Tensor]:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train" and self.cfg.remat and torch.is_grad_enabled():
            # NESTED remat, as the reference's: the outer checkpoint keeps
            # only period-boundary activations; the inner per-layer ones
            # bound the live set during a period's backward to one layer's
            # internals (the forward runs ~3x)
            for p in range(self.n_periods):
                x, aux = checkpoint(self._remat_period, x, aux, p, use_reentrant=False)
            return x, None, aux
        new_caches: List[Cache] = []
        for i, block in enumerate(self.layers):
            x, nc, a = block(self, x, caches[i] if mode == "decode" else None,
                             mode, positions, max_len)
            new_caches.append(nc)
            aux = aux + a
        return x, (None if mode == "train" else new_caches), aux

    def _remat_period(self, x: torch.Tensor, aux: torch.Tensor, p: int,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layers ``[p * period, (p + 1) * period)`` in train mode, each
        under its own checkpoint; aux accumulates in the loop's order."""
        for i in range(p * self.period, (p + 1) * self.period):
            x, a = checkpoint(self._train_layer, x, i, use_reentrant=False)
            aux = aux + a
        return x, aux

    def _train_layer(self, x: torch.Tensor, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _cache, a = self.layers[i](self, x, None, "train", None, 0)
        return x, a

    # -- embedding & frontends --------------------------------------------------

    def _embed_inputs(self, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.embed(tokens)
        if self.cfg.frontend != "none":
            if prefix_embeds is None:
                raise ValueError("the stub frontend needs prefix_embeds")
            pre = prefix_embeds.to(self.dtype) @ self.frontend_proj["w"]
            x = torch.cat([pre, x], dim=1)
        return self.constrain(x, "hidden")

    # -- training forward / loss --------------------------------------------------

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence causal forward. Returns (logits f32, moe_aux)."""
        x = self._embed_inputs(tokens, prefix_embeds)
        x, _caches, aux = self._run_layers(x, None, "train", None)
        x = self.final_norm(x, self.cfg.norm_eps)
        return self.constrain(self.lm_head(x), "logits"), aux

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Next-token CE (+ MoE aux) over the token region; the LM head and
        the softmax-CE are fused and chunked over the sequence."""
        tokens = batch["tokens"]
        x = self._embed_inputs(tokens, batch.get("prefix_embeds"))
        x, _caches, aux = self._run_layers(x, None, "train", None)
        x = self.final_norm(x, self.cfg.norm_eps)
        P = self.cfg.prefix_len if self.cfg.frontend != "none" else 0
        loss = _chunked_softmax_xent(self.lm_head["w"], x[:, P:-1], tokens[:, 1:],
                                     chunk=max(self.cfg.q_chunk, 16),
                                     chunk_fn=self.xent_chunk)
        if self.cfg.n_experts:
            loss = loss + 0.01 * aux
        return loss

    # -- serving -------------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int, device=None) -> List[Cache]:
        """Empty decode caches (capacity ``max_len``), one dict a layer, on
        ``device`` (default: the model's)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        caches: List[Cache] = []
        for i in range(cfg.n_layers):
            if cfg.layer_kind(i) == "attn":
                shape = (batch, max_len, self.KV, cfg.head_dim)
                caches.append({
                    "k": torch.zeros(shape, dtype=self.dtype, device=dev),
                    "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                    "len": torch.zeros((batch,), dtype=torch.int32, device=dev)})
            else:
                conv, ssm = init_ssd_cache(self.ssd_cfg, batch, self.dtype, dev)
                caches.append({"conv": conv, "ssm": ssm})
        return caches

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, List[Cache]]:
        """Run the prompt; returns (last-position logits, caches padded to
        ``max_len`` capacity)."""
        x = self._embed_inputs(tokens, prefix_embeds)
        b, s, _ = x.shape
        x, caches, _aux = self._run_layers(x, None, "prefill", None, max_len=max_len or s)
        x = self.final_norm(x[:, -1:], self.cfg.norm_eps)
        return self.lm_head(x), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[Cache],
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        """One decode step. token: (b, 1) int. Returns (logits, caches); the
        attention caches' k and v are written in place."""
        x = self.constrain(self.embed(token), "hidden")
        x, caches, _aux = self._run_layers(x, caches, "decode", None)
        x = self.final_norm(x, self.cfg.norm_eps)
        return self.lm_head(x), caches


def _chunked_softmax_xent(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                          chunk: int, chunk_fn=None) -> torch.Tensor:
    """Fused LM-head + cross-entropy, chunked over sequence positions so the
    logits working set is (b, chunk, V) instead of (b, s, V). While
    autograd records, each chunk is checkpointed: without it backward keeps
    every chunk's logits, and the (b, s, V) tensor comes back. ``chunk_fn``
    computes one chunk's summed loss (default ``_xent_chunk``)."""
    b, s, d = x.shape
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    mask = torch.arange(x.shape[1], device=x.device) < s
    remat = torch.is_grad_enabled()
    chunk_fn = chunk_fn or _xent_chunk
    totals = []
    for c0 in range(0, x.shape[1], chunk):
        args = (w, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], mask[c0:c0 + chunk])
        totals.append(checkpoint(chunk_fn, *args, use_reentrant=False) if remat
                      else chunk_fn(*args))
    return torch.sum(torch.stack(totals)) / (b * s)


def _xent_chunk(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    logits = (x @ w).float()                                   # (b, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mask)
