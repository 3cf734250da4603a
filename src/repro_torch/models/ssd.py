"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060], chunked
matmul form for training/prefill + O(1)-state recurrent decode step. The
port of ``repro.models.ssd``.

The chunked algorithm splits the sequence into chunks of length Q and
computes (per head):
    intra-chunk:  Y_ij = C_i·B_j * exp(cumA_i - cumA_j) * dt_j * x_j (j<=i)
    chunk state:  S_c  = sum_j exp(cumA_Q - cumA_j) * dt_j * B_j ⊗ x_j
    inter-chunk:  S <- S * exp(sumA_c) + S_c   (scan over chunks)
                  Y_i += C_i · S_prev * exp(cumA_i)
ngroups = 1 (B/C shared across heads). The reference's ``lax.scan`` over
chunks is a Python loop here.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDict, Params, init_device, normal


class SSDConfig(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int        # d_inner // head_dim
    head_dim: int
    d_state: int
    d_conv: int = 4
    chunk: int = 256
    norm_width: int = 0  # what the gated norm's sum of squares is divided
                         # by: 0 is d_inner; a shard of the heads sets the
                         # whole layer's (the other shards' squares summed
                         # in by the caller, or zero)


def init_ssd(gen: Optional[torch.Generator], cfg: SSDConfig, dtype=torch.bfloat16,
             device=None) -> Dict[str, torch.Tensor]:
    dev = init_device(gen, device)
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    h = cfg.n_heads
    conv_ch = di + 2 * n  # x, B, C go through the causal conv
    s_in = 1.0 / math.sqrt(d)
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "w_in": (normal(gen, (d, 2 * di + 2 * n + h), dev) * s_in).to(dtype),
        "conv_w": (normal(gen, (cfg.d_conv, conv_ch), dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "w_out": (normal(gen, (di, d), dev) / math.sqrt(di)).to(dtype),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),  # gated RMSNorm
    }


def _split_proj(cfg: SSDConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.d_state
    return proj[..., :di], proj[..., di: di + di + 2 * n], proj[..., di + di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time as a sum of k shifted slices. xbc:
    (b, s, ch); w: (k, ch). Returns (out, new_state) where the state is
    the last (k-1) inputs."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)                      # (b, s+k-1, ch)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + s] * w[i]
    out = out + b
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return F.silu(out), new_state


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps=1e-6,
                width: int = 0):
    """RMS norm of ``y * silu(z)`` over the last dimension; ``width`` set,
    the sum of squares over it is divided by ``width`` (the whole layer's
    d_inner where ``y`` holds one shard's heads)."""
    y = y * F.silu(z.float()).to(y.dtype)
    if width:
        var = torch.sum(torch.square(y.float()), -1, keepdim=True) / width
    else:
        var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps)).to(y.dtype) * scale


def ssd_chunked(
    x: torch.Tensor,      # (b, s, h, p)
    dt: torch.Tensor,     # (b, s, h) post-softplus
    A: torch.Tensor,      # (h,) negative
    B: torch.Tensor,      # (b, s, n)
    C: torch.Tensor,      # (b, s, n)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (b, h, n, p)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,s,h,p) float32, final_state (b,h,n,p) float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    S = s + pad
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    dA = dtc * A[None, None, None, :]                      # (b,nc,Q,h) negative
    cum = torch.cumsum(dA, dim=2)                           # inclusive cumsum
    # intra-chunk decay matrix L[i,j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,Q,Q,h)
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # mask BEFORE exp: non-causal li is positive and exp overflows
    L = torch.exp(torch.where(causal, li, -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    W = cb[..., None] * L * dtc[:, :, None, :, :]          # (b,nc,Q,Q,h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (b,nc,Q,h)
    state_c = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,nc,h)

    def step(S_prev, sc, dec):
        return S_prev * dec[..., None, None] + sc           # (b,h,n,p)

    S_prev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
              if init_state is None else init_state.float())
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S_prev)
        S_prev = step(S_prev, state_c[:, c], chunk_decay[:, c])
    # the reference's final state: one more step from the last carried state
    S_final = step(S_prevs[-1], state_c[:, -1], chunk_decay[:, -1])
    S_prevs = torch.stack(S_prevs, dim=1)                   # (b,nc,h,n,p)

    # inter-chunk: Y_i += exp(cum_i) * C_i . S_prev
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, S_prevs, torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, S, h, p)[:, :s]
    return y, S_final


def ssd_decode_step(
    x: torch.Tensor,      # (b, 1, h, p)
    dt: torch.Tensor,     # (b, 1, h)
    A: torch.Tensor,      # (h,)
    B: torch.Tensor,      # (b, 1, n)
    C: torch.Tensor,      # (b, 1, n)
    state: torch.Tensor,  # (b, h, n, p) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    dtf = dt[:, 0].float()                                  # (b,h)
    dA = torch.exp(dtf * A[None, :])                        # (b,h)
    upd = torch.einsum("bh,bn,bhp->bhnp", dtf, B[:, 0].float(), x[:, 0].float())
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C[:, 0].float(), state)
    return y[:, None], state


def _no_constraint(t: torch.Tensor, _tag: str) -> torch.Tensor:
    return t


def apply_ssd(
    params: Params,
    cfg: SSDConfig,
    x: torch.Tensor,      # (b, s, d)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (conv, ssm)
    decode: bool = False,
    constrain=None,
):
    """Returns (y (b,s,d), new_cache). ``constrain(x, tag)`` is the hook a
    launcher uses to pin head-parallel layouts (identity by default)."""
    if constrain is None:
        constrain = _no_constraint
    b, s, d = x.shape
    h, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    proj = x @ params["w_in"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state = cache[0] if cache is not None else None
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xs = xbc[..., : cfg.d_inner].reshape(b, s, h, p)
    xs = constrain(xs, "ssm_heads")
    B = xbc[..., cfg.d_inner: cfg.d_inner + n]
    C = xbc[..., cfg.d_inner + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    dt = constrain(dt, "ssm_dt")
    A = -torch.exp(params["A_log"])
    ssm_state = cache[1] if cache is not None else None
    if decode:
        if s != 1 or ssm_state is None:
            raise ValueError("an SSD decode step takes one token and a cache")
        y, ssm_state = ssd_decode_step(xs, dt, A, B, C, ssm_state)
    else:
        y, ssm_state = ssd_chunked(xs, dt, A, B, C, cfg.chunk, ssm_state)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.to(x.dtype).reshape(b, s, cfg.d_inner)
    y = _gated_norm(y, z, params["norm_scale"], width=cfg.norm_width)
    out = y @ params["w_out"]
    return out, (conv_state, ssm_state)


class SSD(ParamDict):
    def forward(self, cfg: SSDConfig, x: torch.Tensor, **kw):
        return apply_ssd(self, cfg, x, **kw)


def init_ssd_cache(cfg: SSDConfig, batch: int, dtype=torch.bfloat16, device=None):
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    return (
        torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype, device=device),
        torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                    dtype=torch.float32, device=device),
    )
