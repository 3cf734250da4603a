"""The port's optimiser (``repro_torch.optim``) against the JAX package's
``repro.optim``, on the CPU: ``adamw_update`` over 20 steps on seeded
trees (float32 and bfloat16 parameters and moments, clipping on and
off), ``lr_schedule`` at every step, ``global_norm`` and
``clip_by_global_norm``, int8 error-feedback ``compress``/``decompress``
(bit-equal) and the port's ``compressed_psum`` against the reference's
compress/decompress per replica, summed and divided (``shard_map``
meshes fail on this jax, so the mean is formed outside one); then the
twins of tests/test_substrates.py's optimiser tests.

Tolerances. Both packages run the same float32 expressions on the same
inputs. They differ in reduction order (the global norm, within a leaf),
in the transcendental functions' last bit, and in rounding: XLA on the
CPU contracts ``b1 * m + (1 - b1) * g`` into a fused multiply-add where
torch rounds each product, so a moment's float32 value may differ by one
ulp. Float32 leaves and metrics are held to 2e-6 x (1 + |ref|) after 20
steps. A bfloat16 leaf holds its float32 value rounded once: where the
two float32 values straddle a rounding boundary it moves by one bfloat16
ulp, and the flip feeds the next steps; bfloat16 leaves are held to
2^-7 x the leaf's largest |ref| (one ulp at the top of its binade; the
worst measured is half of that). ``lr_schedule`` is held to 1e-6
relative plus one float32 ulp of ``cos`` scaled by ``(lr_peak - lr_min)
/ 2`` absolute (near the end of the cosine, ``1 + cos`` cancels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw, compression

SHAPES = {"a": (7, 5), "b": (64,), "c": (3, 4, 6), "d": (1,)}
TOL_F32 = 2e-6
TOL_BF16 = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_dtype(name):
    return {"float32": np.float32, "bfloat16": jnp.bfloat16}[name]


def _tree(rng, dtype, scale=1.0):
    """A seeded dict of arrays in sorted key order (JAX's flatten order)."""
    return {k: (rng.standard_normal(s) * scale).astype(_np_dtype(dtype))
            for k, s in sorted(SHAPES.items())}


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(port, ref, what=""):
    p = port.detach().float().numpy()
    r = np.asarray(ref).astype(np.float32)
    if port.dtype == torch.bfloat16:
        ok = np.abs(p - r) <= TOL_BF16 * np.abs(r).max()
    else:
        ok = np.abs(p - r) <= TOL_F32 * (1 + np.abs(r))
    assert ok.all(), f"{what}: max |err| {np.abs(p - r).max()}"


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference_over_20_steps(dtype, moments, clip):
    kw = dict(lr_peak=1e-2, warmup_steps=5, total_steps=20, clip_norm=clip,
              moment_dtype=moments)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    ref = {k: jnp.asarray(v) for k, v in _tree(rng, dtype).items()}
    params = {k: _t(v) for k, v in ref.items()}
    jstate, state = jadamw.init_adamw(jcfg, ref), adamw.init_adamw(cfg, params)
    step = jax.jit(lambda p, g, s: jadamw.adamw_update(jcfg, p, g, s))
    for i in range(20):
        g = _tree(rng, dtype, scale=0.5 if clip else 0.05)
        ref, jstate, jm = step(ref, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        params, state, metrics = adamw.adamw_update(
            cfg, params, {k: _t(v) for k, v in g.items()}, state)
        assert int(state.step) == int(jstate.step) == i + 1
        assert state.step.dtype == torch.int32 and state.step.dim() == 0
        for k in ("lr", "grad_norm"):
            assert metrics[k].dim() == 0
            _close(metrics[k], jm[k], k)
    for k in SHAPES:
        assert params[k].dtype == _t(ref[k]).dtype
        assert state.m[k].dtype == state.v[k].dtype == _t(jstate.m[k]).dtype
        _close(params[k], ref[k], f"param {k}")
        _close(state.m[k], jstate.m[k], f"m {k}")
        _close(state.v[k], jstate.v[k], f"v {k}")


def test_lr_schedule_every_step():
    kw = dict(lr_peak=3e-3, lr_min=3e-5, warmup_steps=10, total_steps=100)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    steps = np.arange(0, 101, dtype=np.int32)
    ref = np.asarray(jax.vmap(lambda s: jadamw.lr_schedule(jcfg, s))(jnp.asarray(steps)))
    got = torch.stack([adamw.lr_schedule(cfg, torch.tensor(int(s), dtype=torch.int32))
                       for s in steps]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=0.5 * (kw["lr_peak"] - kw["lr_min"]) * 2.0 ** -23)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip(dtype, max_norm):
    tree = _tree(np.random.default_rng(1), dtype)
    ref = {k: jnp.asarray(v) for k, v in tree.items()}
    port = {k: _t(v) for k, v in tree.items()}
    _close(adamw.global_norm(port), jadamw.global_norm(ref), "norm")
    jclipped, jnorm = jadamw.clip_by_global_norm(ref, max_norm)
    clipped, norm = adamw.clip_by_global_norm(port, max_norm)
    _close(norm, jnorm, "norm")
    for k in SHAPES:
        assert clipped[k].dtype == _t(jclipped[k]).dtype
        _close(clipped[k], jclipped[k], k)
    if max_norm == 100.0:   # below the bound: unchanged
        for k in SHAPES:
            assert torch.equal(clipped[k], _t(tree[k]))


def test_compress_decompress_bit_equal_over_steps():
    rng = np.random.default_rng(2)
    shapes = {"w": (64,), "x": (5, 9), "z": (3,)}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    grads[2]["z"][:] = 0.0   # an all-zero leaf: the scale's 1e-12 floor
    jef = jcomp.init_ef({k: jnp.zeros(s) for k, s in shapes.items()})
    ef = compression.init_ef({k: torch.zeros(s) for k, s in shapes.items()})
    for g in grads:
        jq, js, jef = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()}, jef)
        q, s, ef = compression.compress({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        jd, d = jcomp.decompress(jq, js), compression.decompress(q, s)
        for k in shapes:
            assert q[k].dtype == torch.int8 and s[k].dtype == torch.float32
            assert np.array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert np.array_equal(s[k].numpy(), np.asarray(js[k]))
            assert np.array_equal(ef.residual[k].numpy(), np.asarray(jef.residual[k]))
            assert np.array_equal(d[k].numpy(), np.asarray(jd[k]))


def test_round_is_half_to_even_in_both():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0, -127.0], np.float32)
    q, s = compression._quantize(torch.from_numpy(x))
    jq, js = jcomp._quantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.mark.parametrize("n_replicas", [1, 3])
def test_compressed_psum_equals_reference_per_replica(n_replicas):
    """Each replica compresses with its own state; the mean of the
    reference's per-replica dequantized contributions, summed in replica
    order and divided by the replica count, equals the port's bit for bit,
    over three steps of carried residuals."""
    rng = np.random.default_rng(3)
    shapes = {"a": (33,), "b": (4, 8)}
    jefs = [jcomp.init_ef({k: jnp.zeros(s) for k, s in shapes.items()})
            for _ in range(n_replicas)]
    efs = [compression.init_ef({k: torch.zeros(s) for k, s in shapes.items()})
           for _ in range(n_replicas)]
    for _step in range(3):
        grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
                 for _ in range(n_replicas)]
        summed = None
        for r, g in enumerate(grads):
            jq, js, jefs[r] = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()},
                                             jefs[r])
            d = jcomp.decompress(jq, js)
            summed = d if summed is None else {k: summed[k] + d[k] for k in d}
        ref = {k: summed[k] / jnp.float32(n_replicas) for k in summed}
        mean, efs = compression.compressed_psum(
            [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads], efs)
        for k in shapes:
            assert np.array_equal(mean[k].numpy(), np.asarray(ref[k])), k
            for r in range(n_replicas):
                assert np.array_equal(efs[r].residual[k].numpy(),
                                      np.asarray(jefs[r].residual[k]))


def test_compressed_psum_needs_a_state_per_replica():
    g = {"a": torch.ones(3)}
    with pytest.raises(ValueError):
        compression.compressed_psum([g, g], [compression.init_ef(g)])


# -- twins of tests/test_substrates.py's optimiser tests ------------------------


def test_adamw_reduces_quadratic_loss():
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=100,
                            weight_decay=0.0, clip_norm=1.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3, requires_grad=True)}
    state = adamw.init_adamw(cfg, params)

    def loss_fn(p):
        return torch.sum(torch.square(p["w"] - target))

    loss0 = float(loss_fn(params).detach())
    for _ in range(100):
        (g,) = torch.autograd.grad(loss_fn(params), [params["w"]])
        params, state, _m = adamw.adamw_update(cfg, params, {"w": g}, state)
    assert float(loss_fn(params).detach()) < 0.05 * loss0


def test_adamw_bf16_moments_close_to_f32():
    target = torch.from_numpy(np.random.RandomState(0).randn(32).astype(np.float32))

    def run(moment_dtype):
        cfg = adamw.AdamWConfig(lr_peak=0.05, warmup_steps=2, total_steps=60,
                                weight_decay=0.0, moment_dtype=moment_dtype)
        params = {"w": torch.zeros(32, requires_grad=True)}
        state = adamw.init_adamw(cfg, params)
        for _ in range(60):
            (g,) = torch.autograd.grad(torch.sum((params["w"] - target) ** 2),
                                       [params["w"]])
            params, state, _ = adamw.adamw_update(cfg, params, {"w": g}, state)
        return params["w"].detach()

    w32 = run("float32")
    w16 = run("bfloat16")
    # bf16 moments track f32 within a coarse tolerance (documented policy)
    assert float(torch.max(torch.abs(w32 - w16))) < 0.15


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.lr_schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))  # decaying


def test_error_feedback_compression_contracts():
    """EF invariant: sum of dequantized transmissions + final residual equals
    the sum of raw gradients (no gradient information is lost over time)."""
    rng = np.random.RandomState(0)
    grads_seq = [{"w": torch.from_numpy(rng.randn(64).astype(np.float32))}
                 for _ in range(20)]
    ef = compression.init_ef(grads_seq[0])
    sent = torch.zeros(64)
    for g in grads_seq:
        q, s, ef = compression.compress(g, ef)
        sent = sent + compression.decompress(q, s)["w"]
    total = sum(g["w"] for g in grads_seq)
    np.testing.assert_allclose((sent + ef.residual["w"]).numpy(), total.numpy(),
                               rtol=1e-5, atol=1e-5)
    # compression is tight: int8 with per-tensor scale -> bounded error
    assert float(torch.max(torch.abs(ef.residual["w"]))) < \
        float(torch.max(torch.abs(total))) / 10
