"""Shared helpers of the LM tests (tests/test_torch_lm_*.py): reduced
configs, seeded inputs, and both packages' forward, loss, prefill and
teacher-forced decode on the same tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models.params import caches_to_reference

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, N_DECODE = 2, 24, 6


def _reduced(get, arch, **over):
    cfg = get(arch).reduced()
    if arch == "jamba-1.5-large-398b":
        cfg = dataclasses.replace(cfg, n_layers=cfg.period)   # one period: 8 layers
    return dataclasses.replace(cfg, **over)


def _inputs(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    P = cfg.prefix_len if cfg.frontend != "none" else 0
    tokens = rng.integers(0, cfg.vocab_size, (b, s - P)).astype(np.int32)
    prefix = rng.standard_normal((b, P, cfg.d_model)).astype(np.float32) if P else None
    return tokens, prefix, P


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _run_jax(jm, params, tokens, prefix, P):
    """forward + loss, prefill, then teacher-forced decode steps: three
    compiles."""
    batch = {"tokens": jnp.asarray(tokens)}
    if prefix is not None:
        batch["prefix_embeds"] = jnp.asarray(prefix)
    logits, aux, loss = jax.jit(lambda p, bt: (*jm.forward(p, bt["tokens"],
                                                           bt.get("prefix_embeds")),
                                               jm.loss(p, bt)))(params, batch)
    pre_len = S - N_DECODE
    plog, caches = jax.jit(lambda p, t, pe: jm.prefill(p, t, pe, max_len=S))(
        params, jnp.asarray(tokens[:, :pre_len - P]), _jx(prefix))
    out = {"logits": logits, "aux": aux, "loss": loss, "prefill": plog,
           "caches": jax.tree.map(np.asarray, caches), "decode": []}
    step = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        tok = jnp.asarray(tokens[:, pre_len + i - P][:, None])
        dlog, caches = step(params, tok, caches)
        out["decode"].append(dlog)
    return jax.tree.map(np.asarray, out)


def _run_port(m, tokens, prefix, P):
    batch = {"tokens": _t(tokens)}
    if prefix is not None:
        batch["prefix_embeds"] = _t(prefix)
    with torch.no_grad():
        logits, aux = m.forward(batch["tokens"], batch.get("prefix_embeds"))
        loss = m.loss(batch)
    pre_len = S - N_DECODE
    plog, caches = m.prefill(_t(tokens[:, :pre_len - P]), _t(prefix), max_len=S)
    out = {"logits": logits, "aux": aux, "loss": loss, "prefill": plog,
           "caches": caches_to_reference(m, caches), "decode": []}
    for i in range(N_DECODE):
        dlog, caches = m.decode_step(_t(tokens[:, pre_len + i - P][:, None]), caches)
        out["decode"].append(dlog)
    return out


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))
