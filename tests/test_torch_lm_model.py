"""The port's decoder (``repro_torch.models.transformer.Model``) against the
JAX package's, on the CPU, for the ``reduced()`` variant of each of the
ten architectures (jamba at one period, 8 layers, to keep its JAX compile
small): the JAX ``Model.init`` weights go through ``params_from_reference``;
then ``forward`` (logits and MoE aux), ``loss``, ``prefill`` (logits, and
caches through ``caches_to_reference``) and six teacher-forced
``decode_step``s are held against the JAX package's on the same tokens.
Float32 tolerance: 1e-4 absolute and relative (two layers of O(1)
activations; the packages sum in different orders, measured ~7e-6).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_reference
from repro_torch.models.transformer import Model

from _torch_lm import TOL, _close, _inputs, _reduced, _run_jax, _run_port

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """Both packages' outputs per arch, computed once for the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = _reduced(jax_config, arch), _reduced(get_config, arch)
            jm = JaxModel(jcfg)
            params = jax.jit(jm.init)(jax.random.PRNGKey(0))
            m = params_from_reference(Model(cfg, device="cpu"),
                                      jax.tree.map(np.asarray, params))
            tokens, prefix, P = _inputs(cfg)
            cache[arch] = (_run_jax(jm, params, tokens, prefix, P),
                           _run_port(m, tokens, prefix, P))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_logits_and_aux(runs, arch):
    ref, port = runs(arch)
    assert port["logits"].shape == ref["logits"].shape
    _close(port["logits"], ref["logits"])
    _close(port["aux"], ref["aux"])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss(runs, arch):
    ref, port = runs(arch)
    _close(port["loss"], ref["loss"])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_logits_and_caches(runs, arch):
    ref, port = runs(arch)
    _close(port["prefill"], ref["prefill"])
    assert len(port["caches"]) == len(ref["caches"])
    for o, (pc, rc) in enumerate(zip(port["caches"], ref["caches"])):
        assert set(pc) == set(rc), o
        for k in rc:
            assert pc[k].shape == rc[k].shape and pc[k].dtype == rc[k].dtype, (o, k)
            np.testing.assert_allclose(pc[k], rc[k], err_msg=f"offset {o} {k}", **TOL)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_teacher_forced_decode(runs, arch):
    ref, port = runs(arch)
    for i, (p, r) in enumerate(zip(port["decode"], ref["decode"])):
        np.testing.assert_allclose(p.numpy(), r, err_msg=f"decode step {i}", **TOL)
