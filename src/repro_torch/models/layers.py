"""Shared transformer layers: RMSNorm, RoPE, GQA attention (chunked,
memory-bounded), SwiGLU MLP, embeddings. The port of
``repro.models.layers``.

Conventions, as in the reference:
  * every ``init_*`` returns a dict of tensors and has a matching
    ``apply_*`` that reads any mapping of those names: a dict, or the
    :class:`ParamDict` module that holds the same tensors in a model;
  * head counts may be *sharding-padded*: pad q/kv head slots are zero, so
    they contribute nothing to the output projection;
  * attention is chunked over query blocks (scores never materialize more
    than (b, kv, g, q_chunk, kv_len)).

Every function keeps the reference's order of operations and its casts
(float32 inside, the input's dtype out), so bfloat16 rounds where the
reference rounds and the CPU tests hold float32 to tight tolerances.

An ``init_*`` given ``gen=None`` returns uninitialised tensors of the right
shapes and dtypes on ``device`` (``"meta"`` allocates nothing): a model is
built that way and then filled from a seeded generator by ``Model.init``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Mapping[str, torch.Tensor]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def normal(gen: Optional[torch.Generator], shape, device=None) -> torch.Tensor:
    """Standard-normal float32 draws from ``gen`` on the generator's device;
    without a generator an uninitialised float32 tensor on ``device``."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def init_device(gen: Optional[torch.Generator], device) -> torch.device:
    """Where an ``init_*`` puts its tensors: the generator's device, or
    ``device`` without one."""
    return gen.device if gen is not None else torch.device(device)


class ParamDict(nn.Module):
    """A named group of parameters (one of the reference's param dicts):
    ``p["wq"]`` and ``"bq" in p`` read it as the reference reads its dict."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters

    @torch.no_grad()
    def fill_(self, values: Mapping[str, torch.Tensor]) -> None:
        """Copy ``values`` (the same names and shapes) into the parameters."""
        if set(values) != set(self._parameters):
            raise KeyError(f"{sorted(values)} != {sorted(self._parameters)}")
        for name, v in values.items():
            p = self._parameters[name]
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != {tuple(p.shape)}")
            p.copy_(v)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


class RMSNorm(ParamDict):
    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rms_norm(self, x, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., s, heads, head_dim); positions: (..., s). Split halves, not
    interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, chunked)
# ---------------------------------------------------------------------------


def init_attention(
    gen: Optional[torch.Generator],
    d_model: int,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    qkv_bias: bool = False,
    dtype=torch.bfloat16,
    n_heads_logical: Optional[int] = None,
    n_kv_logical: Optional[int] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Padded head slots (>= logical counts) are zero-initialized."""
    dev = init_device(gen, device)
    hl = n_heads_logical or n_heads
    kl = n_kv_logical or n_kv
    scale = 1.0 / math.sqrt(d_model)

    def dense(out_cols, live_cols):
        w = normal(gen, (d_model, out_cols), dev) * scale
        if live_cols < out_cols:
            w[:, live_cols:] = 0.0
        return w.to(dtype)

    p = {"wq": dense(n_heads * head_dim, hl * head_dim),
         "wk": dense(n_kv * head_dim, kl * head_dim),
         "wv": dense(n_kv * head_dim, kl * head_dim)}
    wo = normal(gen, (n_heads * head_dim, d_model), dev)
    wo = wo * (1.0 / math.sqrt(n_heads * head_dim))
    wo[hl * head_dim:, :] = 0.0  # pad head slots contribute nothing
    p["wo"] = wo.to(dtype)
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return p


def _qkv(params: Params, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int):
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    b, s, _ = x.shape
    return (q.reshape(b, s, n_heads, head_dim), k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (b, sq, kv, g, hd), k: (b, skv, kv, hd) -> (b, kv, g, sq, skv),
    float32. The reference scales by a NumPy float64, which promotes a
    bfloat16 product to float32 before the multiply; so does this."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k).float() * scale


def chunked_causal_attention(
    q: torch.Tensor,            # (b, s, H, hd)
    k: torch.Tensor,            # (b, s, KV, hd)
    v: torch.Tensor,            # (b, s, KV, hd)
    q_chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal attention, chunked over query blocks: per-block scores are
    (b, KV, g, q_chunk, s) so the full (s, s) score matrix never
    materializes. ``q_offset`` supports chunked prefill continuation."""
    b, s, H, hd = q.shape
    kvh = k.shape[2]
    g = H // kvh
    scale = 1.0 / math.sqrt(hd)
    pad = (-s) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    n_chunks = q.shape[1] // q_chunk
    qc = q.reshape(b, n_chunks, q_chunk, H, hd)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for ci in range(n_chunks):
        qi = qc[:, ci].reshape(b, q_chunk, kvh, g, hd)
        scores = _grouped_scores(qi, k, scale)                    # (b, kv, g, qc, skv)
        q_pos = q_offset + ci * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]                  # (qc, skv)
        scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
        outs.append(out.reshape(b, q_chunk, H, hd))
    return torch.cat(outs, dim=1)[:, :s]


def decode_attention(
    q: torch.Tensor,            # (b, 1, H, hd)
    k_cache: torch.Tensor,      # (b, S, KV, hd)
    v_cache: torch.Tensor,      # (b, S, KV, hd)
    cache_len: torch.Tensor,    # (b,) or 0-dim int: valid prefix length
) -> torch.Tensor:
    b, _one, H, hd = q.shape
    kvh = k_cache.shape[2]
    g = H // kvh
    scale = 1.0 / math.sqrt(hd)
    qi = q.reshape(b, 1, kvh, g, hd)
    scores = _grouped_scores(qi, k_cache, scale)                 # (b, kv, g, 1, S)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < torch.broadcast_to(cache_len, (b,))[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v_cache)
    return out.reshape(b, 1, H, hd)


def apply_attention(
    params: Params,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 1e4,
    q_chunk: int = 512,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Training/prefill when cache is None (causal over x); decode when
    cache = (k_cache, v_cache, cache_len) and x is a single-token slice.

    Decode writes the new key and value into the caches in place (the
    reference returns updated copies; its serving step donates them) at
    row ``cache_len``, clamped to the last row as the reference's
    ``dynamic_update_slice`` clamps, and attends over ``cache_len + 1``.
    The index comes from device tensors only: no host sync."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim)
    if cache is None:
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        out = chunked_causal_attention(q, k, v, q_chunk=q_chunk)
        new_cache = (k, v, torch.full((b,), s, dtype=torch.int32, device=x.device))
    else:
        k_cache, v_cache, cache_len = cache
        idx = torch.broadcast_to(cache_len, (b,))
        if positions is None:
            positions = idx[:, None].expand(b, s)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        rows = torch.arange(b, device=x.device)
        at = idx.clamp(0, k_cache.shape[1] - 1)
        k_cache[rows, at] = k[:, 0]
        v_cache[rows, at] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, idx + 1)
        new_cache = (k_cache, v_cache, idx + 1)
    y = out.reshape(b, s, -1) @ params["wo"]
    return y, new_cache


class Attention(ParamDict):
    def forward(self, x: torch.Tensor, **kw):
        return apply_attention(self, x, **kw)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    dev = init_device(gen, device)
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": (normal(gen, (d_model, d_ff), dev) * s_in).to(dtype),
        "w_up": (normal(gen, (d_model, d_ff), dev) * s_in).to(dtype),
        "w_down": (normal(gen, (d_ff, d_model), dev) * s_out).to(dtype),
    }


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


class MLP(ParamDict):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(gen: Optional[torch.Generator], vocab: int, d_model: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return {"table": (normal(gen, (vocab, d_model), init_device(gen, device)) * 0.02).to(dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def init_lm_head(gen: Optional[torch.Generator], d_model: int, vocab: int,
                 dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    w = normal(gen, (d_model, vocab), init_device(gen, device)) / math.sqrt(d_model)
    return {"w": w.to(dtype)}


def lm_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["w"]).float()


class Embedding(ParamDict):
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self, tokens)


class LMHead(ParamDict):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lm_logits(self, x)
