"""Serving-path checks of the port's decoder beyond the per-architecture
agreement of tests/test_torch_lm_model.py, on the CPU: qwen1.5-4b at tp=8
(padded heads inert, zero pad slots in the port's own init), a
``params_to_reference`` round trip, the port's prefill + decode against
its own full forward (float32 tolerance 1e-4), and one reduced config in
bfloat16 against the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_reference, params_to_reference
from repro_torch.models.transformer import Model

from _torch_lm import N_DECODE, S, _close, _inputs, _reduced, _run_jax, _run_port, _t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_padded_heads_are_inert():
    """qwen1.5-4b at tp=8 pads 4 heads to 8: the port with the JAX tp=8
    weights equals JAX tp=8, which equals the unpadded model; the port's
    own init zeroes the pad slots."""
    arch = "qwen1.5-4b"
    jm8 = JaxModel(_reduced(jax_config, arch), tp=8)
    params8 = jax.jit(jm8.init)(jax.random.PRNGKey(3))
    m8 = params_from_reference(Model(_reduced(get_config, arch), tp=8, device="cpu"),
                               jax.tree.map(np.asarray, params8))
    assert (m8.H, m8.KV) == (jm8.H, jm8.KV) == (8, 8) and m8.V == jm8.V
    tokens, _, _ = _inputs(m8.cfg, seed=3)
    ref, _ = jax.jit(jm8.forward)(params8, jnp.asarray(tokens))
    with torch.no_grad():
        logits, _ = m8.forward(_t(tokens))
    _close(logits, ref)

    own = Model(m8.cfg, tp=8, device="cpu").init(torch.Generator().manual_seed(0))
    live = m8.cfg.n_heads * m8.cfg.head_dim
    kv_live = m8.cfg.n_kv_heads * m8.cfg.head_dim
    for block in own.layers:
        assert torch.count_nonzero(block.attn["wq"][:, live:]) == 0
        assert torch.count_nonzero(block.attn["wk"][:, kv_live:]) == 0
        assert torch.count_nonzero(block.attn["wo"][live:]) == 0
        assert torch.count_nonzero(block.attn["wq"][:, :live]) == block.attn["wq"][:, :live].numel()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "paligemma-3b"])
def test_params_round_trip(arch):
    """params_to_reference inverts params_from_reference leaf for leaf
    (the hybrid's 8-layer period, the VLM's frontend projection)."""
    jm = JaxModel(_reduced(jax_config, arch))
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(5)))
    back = params_to_reference(params_from_reference(
        Model(_reduced(get_config, arch), device="cpu"), tree))
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    back_flat, back_def = jax.tree_util.tree_flatten_with_path(back)
    assert treedef == back_def
    for (path, a), (_, b) in zip(flat, back_flat):
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m", "jamba-1.5-large-398b",
                                  "dbrx-132b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """Teacher forcing on the port alone, from its own seeded init: the
    logits of prefill + decode steps equal its full causal forward at the
    same positions (tests/test_arch_smoke.py's case, at the float32
    tolerance above)."""
    cfg = _reduced(get_config, arch)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    tokens, prefix, P = _inputs(cfg, seed=2)
    with torch.no_grad():
        full, _ = m.forward(_t(tokens), _t(prefix))
    pre_len = S - N_DECODE
    logits, caches = m.prefill(_t(tokens[:, :pre_len - P]), _t(prefix), max_len=S)
    _close(logits[:, 0], full[:, pre_len - 1].numpy())
    for i in range(N_DECODE):
        pos = pre_len + i
        logits, caches = m.decode_step(_t(tokens[:, pos - P][:, None]), caches)
        _close(logits[:, 0], full[:, pos].numpy())


def test_bfloat16_reduced_config():
    """qwen2.5-14b reduced (GQA, QKV bias) in bfloat16, the configs' own
    param dtype, from the JAX package's bfloat16 weights: finite forward,
    prefill and decode logits within 0.1 absolute of the JAX package's.
    bfloat16's step at the logits' largest magnitude (~4) is 2^-6; the
    packages round the same operations but XLA fuses and sums in its own
    order, which measured 0.043 here. (A MoE config is not used: a
    bfloat16 near-tie in the router flips an expert, by design.)"""
    arch = "qwen2.5-14b"
    jm = JaxModel(_reduced(jax_config, arch, param_dtype="bfloat16"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(7))
    m = params_from_reference(
        Model(_reduced(get_config, arch, param_dtype="bfloat16"), device="cpu"),
        jax.tree.map(np.asarray, params))
    assert m.embed["table"].dtype == torch.bfloat16
    tokens, prefix, P = _inputs(m.cfg, seed=7)
    ref = _run_jax(jm, params, tokens, prefix, P)
    port = _run_port(m, tokens, prefix, P)
    tol = dict(rtol=0, atol=0.1)
    assert torch.isfinite(port["logits"]).all()
    _close(port["logits"], ref["logits"], **tol)
    _close(port["prefill"], ref["prefill"], **tol)
    for p, r in zip(port["decode"], ref["decode"]):
        _close(p, r, **tol)
