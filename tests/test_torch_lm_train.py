"""The port's LM training (``repro_torch.launch.train``, the optimiser
state's layout in ``repro_torch.models.params``, remat in
``repro_torch.models.transformer``) against the JAX package's, on the CPU.

* ``Model.loss`` and its gradient against ``jax.value_and_grad`` for the
  ``reduced()`` variant of all ten architectures (jamba at one period),
  and for dbrx, llama4-scout and jamba at ``capacity_factor=0.5``, where
  tokens drop: within 1e-4 x (1 + |ref|) (measured <= 6.5e-6 and 8.2e-6).
* ``make_train_step`` against the reference's, 3 steps on the same
  ``TokenPipeline`` batches from the reference's weights and optimiser
  state, at ``microbatches`` 1 and 2 (bfloat16 accumulation), for smollm
  and dbrx: loss, lr and grad norm, then the parameters and both moments
  after every step.
* remat on equals remat off bit for bit (loss and every gradient), and
  keeps fewer activations for backward.
* ``make_eval_step``, ``abstract_opt_state`` (through the layout map,
  against the reference's ``eval_shape``), the CLI with a checkpoint that
  the JAX package's ``ckpt.restore`` reads into its own tree, and the new
  modules importing with ``jax`` and ``repro`` blocked.

The train step's rule for parameters. Each of the 3 steps starts both
packages from the reference's weights and optimiser state, so an error
cannot compound. Adam's update ``u = mhat / (sqrt(vhat) + eps)`` moves
by about ``(1 - b1) / bc1 * dg / sqrt(vhat)`` for a gradient error
``dg``, and its first step is ~``sign(g)``: where the gradient lies
within its tolerance of zero the sign, and the parameter, may differ by
up to 2 lr. So every entry is held to 1e-5 x (1 + |ref|) plus ``2 lr x
min(1, (1 - b1) / bc1 * eps_g / (sqrt(vhat) + eps))``, the gradient
tolerance ``eps_g`` propagated through the reference's own update and
capped at a flipped sign: ``eps_g`` is 1e-4 x (1 + |g|) (the gradient
tests' tolerance) times the step's clip scale, and at ``microbatches=2``
also 2^-8 x (|g_1| + |g_2|) / 2 + 2^-8 |g|, the bfloat16 rounding of each
microbatch's share and of their sum (where the two shares cancel, their
rounding is most of the sum). ``g`` is the reference's gradient of the
step, recovered from its moments, ``(m_t - b1 m_{t-1}) / (1 - b1)`` over
the clip scale; ``g_i`` are the reference's microbatch gradients. The
entries that need the second term are counted and must stay under 0.2%
of the parameters. Moments are held to 1e-4 x (1 + |ref|), loss and grad
norm to 1e-4 x (1 + |ref|), the lr to 1e-7 relative.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.data.tokens import TokenPipeline
from repro.launch import specs as jax_specs
from repro.launch import train as jtrain
from repro.models.transformer import Model as JaxModel
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.launch import specs, train
from repro_torch.models.params import (named_from_reference, named_to_reference,
                                       opt_state_from_reference, opt_state_to_reference,
                                       params_from_reference, params_to_reference)
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, init_adamw

from _torch_lm import _inputs, _reduced, _t

SRC = Path(__file__).resolve().parents[1] / "src"
TOL_GRAD = 1e-4
TOL_PARAM = 1e-5
TOL_STATE = 1e-4
SIGN_SHARE = 0.002
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(arch, **over):
    """(JAX model, seeded weights in its layout as numpy, the port's model
    holding them). The weights are the port's seeded init carried over by
    ``params_to_reference``: a JAX ``init`` compile per config would cost
    more than the gradient it is compared on."""
    jcfg, cfg = _reduced(jax_config, arch, **over), _reduced(get_config, arch, **over)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return JaxModel(jcfg), params_to_reference(m), m


def _batch(cfg, seed, b=2, s=32):
    tokens, prefix, _P = _inputs(cfg, seed=seed, b=b, s=s)
    return {"tokens": tokens, **({} if prefix is None else {"prefix_embeds": prefix})}


def _worst(port, ref):
    p, r = port.detach().float().numpy(), np.asarray(ref).astype(np.float32)
    return float((np.abs(p - r) / (1 + np.abs(r))).max())


_JAX_GRAD = {}


def _jax_grad(arch, **over):
    """The reference's jitted ``value_and_grad`` of ``Model.loss``, one
    compile per (arch, options) in this module: the microbatch gradients
    of the train-step test reuse the gradient test's."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _JAX_GRAD:
        jm = JaxModel(_reduced(jax_config, arch, **over))
        _JAX_GRAD[key] = jax.jit(jax.value_and_grad(jm.loss))
    return _JAX_GRAD[key]


def _grads_case(arch, **over):
    _jm, params, m = _pair(arch, **over)
    batch = _batch(m.cfg, seed=5)
    jloss, jgrads = _jax_grad(arch, **over)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = named_from_reference(m, jax.tree.map(np.asarray, jgrads))
    named = dict(m.named_parameters())
    loss = m.loss({k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _worst(loss, jloss) <= TOL_GRAD
    assert set(ref) == set(named)
    for (k, p), g in zip(named.items(), grads):
        assert g.shape == p.shape and g.dtype == p.dtype, k
        assert _worst(g, ref[k]) <= TOL_GRAD, (k, _worst(g, ref[k]))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_gradients_equal_reference(arch):
    _grads_case(arch)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b"])
def test_loss_gradients_equal_reference_with_dropped_tokens(arch):
    _grads_case(arch, capacity_factor=0.5)


# -- the train step ----------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ["smollm-360m", "dbrx-132b"])
def test_train_step_equals_reference(arch, M):
    jm, params, m = _pair(arch, microbatches=M)
    jcfg, cfg = jadamw.AdamWConfig(**OPT), AdamWConfig(**OPT)
    jstate = jax.tree.map(np.asarray, jadamw.init_adamw(jcfg, params))
    jstep = jax.jit(jtrain.make_train_step(jm, jcfg))
    step = train.make_train_step(m, cfg)
    pipe = TokenPipeline(vocab_size=m.cfg.vocab_size, seq_len=32, batch_per_host=4, seed=7)
    n_params = sum(p.numel() for p in m.parameters())
    try:
        for i in range(3):
            batch = next(pipe)
            # both packages start the step from the reference's state
            params_from_reference(m, params)
            state = opt_state_from_reference(m, jstate)
            m_prev = named_from_reference(m, jstate.m)
            mb_grads = []
            if M > 1:
                for j in range(M):
                    half = {k: jnp.asarray(v[j * 4 // M:(j + 1) * 4 // M]) for k, v in batch.items()}
                    mb_grads.append(named_from_reference(m, jax.tree.map(
                        np.asarray, _jax_grad(arch)(params, half)[1])))
            params, jstate, jmet = jax.tree.map(np.asarray, jstep(
                params, jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
            m, state, met = step(m, state, {k: _t(v) for k, v in batch.items()})
            assert int(state.step) == int(jstate.step) == i + 1
            assert _worst(met["loss"], jmet["loss"]) <= TOL_STATE
            assert _worst(met["grad_norm"], jmet["grad_norm"]) <= TOL_STATE
            np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-7)
            lr = float(jmet["lr"])
            scale = min(1.0, cfg.clip_norm / (float(jmet["grad_norm"]) + 1e-9))
            bc1, bc2 = 1 - cfg.b1 ** (i + 1), 1 - cfg.b2 ** (i + 1)
            ref_p = named_from_reference(m, params)
            ref_m = named_from_reference(m, jstate.m)
            ref_v = named_from_reference(m, jstate.v)
            excused = 0
            for k, p in m.named_parameters():
                assert _worst(state.m[k], ref_m[k]) <= TOL_STATE, (i, k)
                assert _worst(state.v[k], ref_v[k]) <= TOL_STATE, (i, k)
                g = (ref_m[k] - cfg.b1 * m_prev[k]) / (1 - cfg.b1) / scale
                eps_g = TOL_GRAD * (1 + g.abs())
                if mb_grads:
                    eps_g = eps_g + 2.0 ** -8 * (sum(gi[k].abs() for gi in mb_grads) / M
                                                 + g.abs())
                reach = (1 - cfg.b1) / bc1 * eps_g * scale / (
                    (ref_v[k] / bc2).sqrt() + cfg.eps)
                tight = TOL_PARAM * (1 + ref_p[k].abs())
                err = (p.detach() - ref_p[k]).abs()
                assert (err <= tight + 2 * lr * reach.clamp(max=1.0)).all(), \
                    (i, k, float((err - tight).max()))
                excused += int((err > tight).sum())
            assert excused <= SIGN_SHARE * n_params, (i, excused, n_params)
    finally:
        pipe.close()


def test_train_step_metrics_stay_on_the_device():
    _jm, _params, m = _pair("smollm-360m", microbatches=2)
    cfg = AdamWConfig(**OPT)
    state = init_adamw(cfg, m)
    _m, state, met = train.make_train_step(m, cfg)(
        m, state, {"tokens": torch.from_numpy(_batch(m.cfg, 1, b=4)["tokens"])})
    assert set(met) == {"loss", "lr", "grad_norm"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 and v.dtype == torch.float32
               for v in met.values())
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    assert all(p.grad is None for p in m.parameters())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_on_equals_off_bit_for_bit(arch):
    """The nested per-period and per-layer checkpoints recompute the same
    operations in the same order: loss and every gradient equal; fewer
    tensors outside the checkpoints are kept for backward."""
    cfg = _reduced(get_config, arch)
    assert cfg.remat
    on = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    off = Model(dataclasses.replace(cfg, remat=False), device="cpu")
    off.load_state_dict(on.state_dict())
    batch = {k: _t(v) for k, v in _batch(cfg, seed=9).items()}
    out = []
    for model in (on, off):
        kept = []

        def pack(t):
            kept.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads, sum(kept)))
    (l_on, g_on, kept_on), (l_off, g_off, kept_off) = out
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    assert kept_on < kept_off


def test_checkpoints_only_while_autograd_records(monkeypatch):
    """With autograd recording, one checkpoint a period, one a layer and one
    a cross-entropy chunk; under ``no_grad`` (the serving entry points and
    the eval step) none, and the same loss."""
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn.__name__) or real(fn, *a, **kw))
    cfg = _reduced(get_config, "jamba-1.5-large-398b")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    batch = {"tokens": _t(_batch(cfg, seed=2)["tokens"])}
    with torch.no_grad():
        quiet = m.loss(batch)
    assert calls == []
    loud = m.loss(batch)
    chunks = -(-31 // max(cfg.q_chunk, 16))
    assert sorted(set(calls)) == ["_remat_period", "_train_layer", "_xent_chunk"]
    assert [calls.count(n) for n in ("_remat_period", "_train_layer", "_xent_chunk")] == \
        [m.n_periods, cfg.n_layers, chunks]
    assert torch.equal(quiet, loud.detach())


def test_eval_step_equals_reference_loss():
    jm, params, m = _pair("qwen2.5-14b")
    batch = _batch(m.cfg, seed=11)
    ref = jax.jit(jtrain.make_eval_step(jm))(params,
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = train.make_eval_step(m)(m, {k: _t(v) for k, v in batch.items()})
    assert not got.requires_grad
    assert _worst(got, ref) <= TOL_GRAD


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_opt_state_equals_reference(arch):
    cfg = get_config(arch)
    m = Model(cfg, device="meta")
    opt = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    state = specs.abstract_opt_state(m, opt)
    ref = jax_specs.abstract_opt_state(JaxModel(jax_config(arch)),
                                       jadamw.AdamWConfig(moment_dtype=cfg.opt_state_dtype))
    assert state.step.device.type == "meta" and state.step.shape == ()
    assert str(ref.step.dtype) == "int32" and state.step.dtype == torch.int32
    for port_tree, ref_tree in ((state.m, ref.m), (state.v, ref.v)):
        assert all(t.device.type == "meta" for t in port_tree.values())
        mapped = jax.tree_util.tree_flatten_with_path(named_to_reference(m, port_tree))[0]
        want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        assert [p for p, _ in mapped] == [p for p, _ in want]
        for (path, a), (_p, b) in zip(mapped, want):
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path


def test_opt_state_round_trips_through_the_reference_layout():
    jm, params, m = _pair("jamba-1.5-large-398b")
    jstate = jadamw.init_adamw(jadamw.AdamWConfig(moment_dtype="bfloat16"), params)
    rng = np.random.default_rng(0)
    ref = jadamw.AdamWState(
        step=np.asarray(5, np.int32),
        m=jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype), jstate.m),
        v=jax.tree.map(lambda x: rng.random(x.shape).astype(x.dtype), jstate.v))
    state = opt_state_from_reference(m, ref)
    assert int(state.step) == 5 and state.step.dtype == torch.int32
    assert all(t.dtype == torch.bfloat16 for t in state.m.values())
    back = opt_state_to_reference(m, state)
    assert type(back).__name__ == "AdamWState" and back._fields == ref._fields
    assert int(back.step) == 5
    for a, b in ((back.m, ref.m), (back.v, ref.v)):
        la, lb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in la] == [p for p, _ in lb]
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_reference_trees_are_copies():
    """The reference-layout trees do not alias the port's tensors, which
    the optimiser updates in place."""
    _jm, params, m = _pair("smollm-360m")
    state = init_adamw(AdamWConfig(), m)
    opt = opt_state_to_reference(m, state)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
        for t in list(state.m.values()) + list(state.v.values()):
            t.add_(1.0)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params_to_reference(m))):
        assert np.array_equal(a + 1.0, b)
    assert all(not x.any() for x in jax.tree.leaves((opt.m, opt.v)))


def test_cli_checkpoint_restores_in_the_reference(tmp_path, capsys):
    """The CLI on the CPU (reduced smollm, 3 steps, a checkpoint at step 3):
    the JAX package's ``ckpt.restore`` reads it into the reference's own
    ``{"params", "opt"}`` tree, equal to the port's state through
    ``params_to_reference`` and ``opt_state_to_reference``; the manifest's
    keys are the reference tree's."""
    d = str(tmp_path / "ckpt")
    model, state = train.main(["--arch", "smollm-360m", "--steps", "3", "--batch", "4",
                               "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "3",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "step     2  loss" in out and "done: 3 steps" in out
    jm = JaxModel(jax_config("smollm-360m").reduced())
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    like = {"params": params,
            "opt": jax.eval_shape(lambda p: jadamw.init_adamw(jadamw.AdamWConfig(), p), params)}
    tree, extra = jckpt.restore(d, like)
    assert extra == {"step": 3, "cursor": 3}
    manifest = jckpt._flatten(like)
    import json
    with open(os.path.join(jckpt.latest_step_dir(d), "manifest.json")) as f:
        assert set(json.load(f)["arrays"]) == set(manifest)
    want = {"params": params_to_reference(model), "opt": opt_state_to_reference(model, state)}
    got_l = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0]
    want_l = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [str(p) for p, _ in got_l] == [str(p) for p, _ in want_l]
    for (path, a), (_p, b) in zip(got_l, want_l):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b), path


def test_train_modules_import_without_jax_or_repro():
    code = ("import sys\n"
            "for name in ('jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
            "import repro_torch.launch.train, repro_torch.launch.specs\n"
            "import repro_torch.models.params\n"
            "import torch\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.launch.train import make_train_step\n"
            "from repro_torch.models.transformer import Model\n"
            "from repro_torch.optim.adamw import AdamWConfig, init_adamw\n"
            "m = Model(get_config('smollm-360m').reduced(), device='cpu')\n"
            "m.init(torch.Generator().manual_seed(0))\n"
            "cfg = AdamWConfig()\n"
            "_m, st, met = make_train_step(m, cfg)(m, init_adamw(cfg, m),\n"
            "    {'tokens': torch.zeros((2, 8), dtype=torch.int64)})\n"
            "assert torch.isfinite(met['loss']) and int(st.step) == 1\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "['jax', 'repro']"
