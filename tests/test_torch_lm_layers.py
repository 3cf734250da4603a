"""The LM layers of the port (``repro_torch.models.layers``, ``.ssd`` and
``.moe``) against the JAX package's, on the CPU: the same numpy inputs
from a seeded generator through each JAX function and its port, float32.
Tolerance: 1e-5 absolute and relative (the two packages sum in different
orders; the values here are O(1)). Integer outputs (the MoE's chosen
experts, queue positions and kept slots) are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import ssd as jssd
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssd as tssd

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread per test worker (the
    default spins against the other workers for the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jit(fn, **static):
    """A JAX function compiled once with its keyword arguments fixed (one
    compile instead of one per primitive)."""
    return jax.jit(lambda *a: fn(*a, **static))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    """numpy (or JAX) leaves -> torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_j(v) for v in tree)
    return jnp.asarray(tree)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _attn_params(rng, d, H, KV, hd, bias):
    p = {"wq": _rand(rng, d, H * hd, scale=d ** -0.5),
         "wk": _rand(rng, d, KV * hd, scale=d ** -0.5),
         "wv": _rand(rng, d, KV * hd, scale=d ** -0.5),
         "wo": _rand(rng, H * hd, d, scale=(H * hd) ** -0.5)}
    if bias:
        p.update(bq=_rand(rng, H * hd, scale=0.1), bk=_rand(rng, KV * hd, scale=0.1),
                 bv=_rand(rng, KV * hd, scale=0.1))
    return p


# -- norms, rope, attention ----------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 32, scale=3.0), _rand(rng, 32)
    _close(tl.rms_norm(_t({"scale": scale}), _t(x), 1e-6),
           jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 4096, (2, 9))
    _close(tl.apply_rope(_t(x), _t(pos), theta), jl.apply_rope(jnp.asarray(x),
                                                                 jnp.asarray(pos), theta),
           rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("H,KV", [(4, 2), (6, 1), (2, 2)])
def test_chunked_causal_attention(H, KV):
    """s = 21 is no multiple of q_chunk = 8 (the last block is padded);
    g = H // KV > 1 groups query heads."""
    rng = np.random.default_rng(H * 10 + KV)
    b, s, hd = 2, 21, 16
    q, k, v = _rand(rng, b, s, H, hd), _rand(rng, b, s, KV, hd), _rand(rng, b, s, KV, hd)
    _close(tl.chunked_causal_attention(_t(q), _t(k), _t(v), q_chunk=8),
           _jit(jl.chunked_causal_attention, q_chunk=8)(*_j((q, k, v))))


def test_decode_attention_per_row_cache_len():
    rng = np.random.default_rng(3)
    b, S, H, KV, hd = 3, 12, 4, 2, 16
    q = _rand(rng, b, 1, H, hd)
    kc, vc = _rand(rng, b, S, KV, hd), _rand(rng, b, S, KV, hd)
    for cache_len in (np.array([1, 7, 12], np.int32), np.array(5, np.int32)):
        _close(tl.decode_attention(_t(q), _t(kc), _t(vc), _t(cache_len)),
               jl.decode_attention(*_j((q, kc, vc, cache_len))))


@pytest.mark.parametrize("bias", [False, True])
def test_apply_attention_prefill(bias):
    rng = np.random.default_rng(4)
    b, s, d, H, KV, hd = 2, 19, 32, 4, 2, 16
    p, x = _attn_params(rng, d, H, KV, hd, bias), _rand(rng, b, s, d)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, q_chunk=8)
    y, (k, v, ln) = tl.apply_attention(_t(p), _t(x), **kw)
    jy, (jk, jv, jln) = _jit(jl.apply_attention, **kw)(_j(p), jnp.asarray(x))
    for port, ref in ((y, jy), (k, jk), (v, jv)):
        _close(port, ref)
    assert ln.dtype == torch.int32 and np.array_equal(ln.numpy(), np.asarray(jln))


@pytest.mark.parametrize("bias", [False, True])
def test_apply_attention_decode_with_clamped_write(bias):
    """One token a row at per-row cache lengths, one of them == S: JAX
    clamps that row's write to the last slot and attends over S + 1; the
    port writes the caches in place and must do the same."""
    rng = np.random.default_rng(5 + bias)
    b, S, d, H, KV, hd = 3, 10, 32, 4, 2, 16
    p, x = _attn_params(rng, d, H, KV, hd, bias), _rand(rng, b, 1, d)
    kc, vc = _rand(rng, b, S, KV, hd), _rand(rng, b, S, KV, hd)
    cache_len = np.array([0, 6, S], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd)
    cache = _t((kc, vc, cache_len))
    y, (k, v, ln) = tl.apply_attention(_t(p), _t(x), cache=cache, **kw)
    jy, (jk, jv, jln) = jax.jit(lambda p_, x_, c_: jl.apply_attention(p_, x_, cache=c_, **kw))(
        _j(p), jnp.asarray(x), _j((kc, vc, cache_len)))
    for port, ref in ((y, jy), (k, jk), (v, jv)):
        _close(port, ref)
    assert k.data_ptr() == cache[0].data_ptr()        # written in place
    assert np.array_equal(ln.numpy(), np.asarray(jln))
    # the clamped row's last slot holds the new key
    assert not np.allclose(k.numpy()[2, S - 1], kc[2, S - 1])


def test_apply_mlp():
    rng = np.random.default_rng(6)
    d, f = 32, 48
    p = {"w_gate": _rand(rng, d, f, scale=d ** -0.5), "w_up": _rand(rng, d, f, scale=d ** -0.5),
         "w_down": _rand(rng, f, d, scale=f ** -0.5)}
    x = _rand(rng, 2, 7, d)
    _close(tl.apply_mlp(_t(p), _t(x)), jl.apply_mlp(_j(p), jnp.asarray(x)))


# -- SSD ---------------------------------------------------------------------------

SSD_CFG = dict(d_model=32, d_inner=64, n_heads=4, head_dim=16, d_state=8, chunk=8)


def _ssd_params(rng):
    cfg = SSD_CFG
    d, di, n, h = cfg["d_model"], cfg["d_inner"], cfg["d_state"], cfg["n_heads"]
    return {"w_in": _rand(rng, d, 2 * di + 2 * n + h, scale=d ** -0.5),
            "conv_w": _rand(rng, 4, di + 2 * n, scale=0.3),
            "conv_b": _rand(rng, di + 2 * n, scale=0.1),
            "A_log": np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
            "dt_bias": _rand(rng, h, scale=0.5), "D": _rand(rng, h),
            "w_out": _rand(rng, di, d, scale=di ** -0.5),
            "norm_scale": 1.0 + _rand(rng, di, scale=0.1)}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(7)
    xbc, w, bias = _rand(rng, 2, 9, 24), _rand(rng, 4, 24), _rand(rng, 24)
    state = _rand(rng, 2, 3, 24) if with_state else None
    out, st = tssd._causal_conv(_t(xbc), _t(w), _t(bias), None if state is None else _t(state))
    jout, jst = jssd._causal_conv(*_j((xbc, w, bias)),
                                  None if state is None else jnp.asarray(state))
    _close(out, jout)
    _close(st, jst, rtol=0, atol=0)


@pytest.mark.parametrize("s,init", [(21, False), (21, True), (16, True), (5, False)])
def test_ssd_chunked(s, init):
    """s = 21 and 5 pad the last chunk of 8; an initial state carries in."""
    rng = np.random.default_rng(s + init)
    b, h, p, n = 2, 4, 16, 8
    x, B, C = _rand(rng, b, s, h, p), _rand(rng, b, s, n), _rand(rng, b, s, n)
    dt = np.log1p(np.exp(_rand(rng, b, s, h)))
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    st = _rand(rng, b, h, n, p) if init else None
    y, final = tssd.ssd_chunked(*_t((x, dt, A, B, C)), 8, None if st is None else _t(st))
    jy, jfinal = jax.jit(lambda *a: jssd.ssd_chunked(*a[:5], 8, a[5]))(
        *_j((x, dt, A, B, C)), None if st is None else jnp.asarray(st))
    _close(y, jy)
    _close(final, jfinal)


def test_ssd_decode_step():
    rng = np.random.default_rng(8)
    b, h, p, n = 3, 4, 16, 8
    x, B, C = _rand(rng, b, 1, h, p), _rand(rng, b, 1, n), _rand(rng, b, 1, n)
    dt = np.log1p(np.exp(_rand(rng, b, 1, h)))
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    st = _rand(rng, b, h, n, p)
    y, new = tssd.ssd_decode_step(*_t((x, dt, A, B, C, st)))
    jy, jnew = jssd.ssd_decode_step(*_j((x, dt, A, B, C, st)))
    _close(y, jy)
    _close(new, jnew)


@pytest.mark.parametrize("decode", [False, True])
def test_apply_ssd(decode):
    rng = np.random.default_rng(9 + decode)
    params = _ssd_params(rng)
    s = 1 if decode else 13
    x = _rand(rng, 2, s, SSD_CFG["d_model"])
    cache = None
    if decode:
        cache = (_rand(rng, 2, 3, SSD_CFG["d_inner"] + 2 * SSD_CFG["d_state"]),
                 _rand(rng, 2, SSD_CFG["n_heads"], SSD_CFG["d_state"], SSD_CFG["head_dim"]))
    y, (conv, ssm) = tssd.apply_ssd(_t(params), tssd.SSDConfig(**SSD_CFG), _t(x),
                                    cache=None if cache is None else _t(cache), decode=decode)
    jy, (jconv, jssm) = jax.jit(lambda p_, x_, c_: jssd.apply_ssd(
        p_, jssd.SSDConfig(**SSD_CFG), x_, cache=c_, decode=decode))(
        _j(params), jnp.asarray(x), None if cache is None else _j(cache))
    for port, ref in ((y, jy), (conv, jconv), (ssm, jssm)):
        _close(port, ref)


# -- MoE -----------------------------------------------------------------------------


def _moe_params(rng, d=32, f=48, E=4):
    return {"router": _rand(rng, d, E, scale=d ** -0.5),
            "w_gate": _rand(rng, E, d, f, scale=d ** -0.5),
            "w_up": _rand(rng, E, d, f, scale=d ** -0.5),
            "w_down": _rand(rng, E, f, d, scale=f ** -0.5)}


def _jax_routing(params, xt, top_k, capacity_factor):
    """The reference's routing, as ``repro.models.moe._moe_group`` computes
    it (moe.py:75-89): experts, queue positions, kept slots."""
    T = xt.shape[0]
    E = params["w_gate"].shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], axis=-1)
    _gates, expert_idx = jax.lax.top_k(probs, top_k)
    capacity = max(int(np.ceil(capacity_factor * T * top_k / E)), 1)
    flat = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32).reshape(T * top_k, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos_in_expert = jnp.sum(pos * flat, axis=-1).reshape(T, top_k)
    return np.asarray(expert_idx), np.asarray(pos_in_expert), np.asarray(
        pos_in_expert < capacity)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_apply_moe(n_groups, capacity_factor, top_k):
    """Ample capacity (8.0) and a capacity that drops (token, slot) pairs
    (0.5): outputs, aux, and each group's experts, positions and kept
    slots equal the reference's."""
    rng = np.random.default_rng(11 + n_groups + top_k)
    params = _moe_params(rng)
    x = _rand(rng, 2, 12, 32)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, n_groups=n_groups)
    y, aux = tmoe.apply_moe(_t(params), _t(x), **kw)
    jy, jaux = _jit(jmoe.apply_moe, **kw)(_j(params), jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    groups = x.reshape(n_groups, -1, 32)
    kept = 0
    for g in range(n_groups):
        r = tmoe.route(_t(params), _t(groups[g]), top_k, capacity_factor)
        e, pos, keep = _jax_routing(_j(params), jnp.asarray(groups[g]), top_k,
                                    capacity_factor)
        assert np.array_equal(r.expert_idx.numpy(), e)
        assert np.array_equal(r.pos_in_expert.numpy(), pos)
        assert np.array_equal(r.keep.numpy(), keep)
        kept += int(keep.sum())
    total = x.shape[0] * x.shape[1] * top_k
    assert (kept < total) == (capacity_factor < 1.0), (kept, total)


def test_route_ties_go_to_the_lower_expert():
    """Equal router probabilities: lax.top_k's order (ties to the lower
    index), which decides who is dropped at capacity."""
    params = {"router": np.zeros((8, 4), np.float32),
              "w_gate": np.zeros((4, 8, 8), np.float32)}
    x = np.ones((5, 8), np.float32)
    r = tmoe.route(_t(params), _t(x), 2, 0.5)
    e, pos, keep = _jax_routing(_j(params), jnp.asarray(x), 2, 0.5)
    assert np.array_equal(r.expert_idx.numpy(), e) and (e == [0, 1]).all()
    assert np.array_equal(r.pos_in_expert.numpy(), pos)
    assert np.array_equal(r.keep.numpy(), keep)
