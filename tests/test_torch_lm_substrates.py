"""The LM substrates of the port against the JAX package's, on the CPU:
every config and its ``reduced()`` field by field with the derived counts;
``SHAPES`` and ``shape_applicable``; ``TokenPipeline``'s batches and
cursors; the serving specs' shapes and dtypes against JAX's
``eval_shape``, leaf by leaf; and that the LM modules import with ``jax``
and ``repro`` unimportable.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.launch import specs as jax_specs
from repro.models.transformer import Model as JaxModel
from repro_torch import configs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import specs
from repro_torch.models.transformer import Model

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch", jax_configs.ARCH_NAMES)
def test_config_equals_reference(arch):
    ref, port = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    for a, b in ((port, ref), (port.reduced(), ref.reduced())):
        assert a.period == b.period and a.d_inner == b.d_inner
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert [a.layer_kind(i) for i in range(a.n_layers)] == \
            [b.layer_kind(i) for i in range(b.n_layers)]
        assert [a.mlp_kind(i) for i in range(a.n_layers)] == \
            [b.mlp_kind(i) for i in range(b.n_layers)]
        for tp in (1, 8, 16):
            assert a.padded_heads(tp) == b.padded_heads(tp)
            assert a.padded_vocab(tp) == b.padded_vocab(tp)
            assert a.param_count(logical=False, tp=tp) == b.param_count(logical=False, tp=tp)


def test_registry_shapes_and_applicability():
    assert configs.ARCH_NAMES == jax_configs.ARCH_NAMES
    assert configs.LONG_CONTEXT_ARCHS == jax_configs.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for arch in configs.ARCH_NAMES:
        for name in configs.SHAPES:
            assert configs.shape_applicable(configs.get_config(arch), configs.SHAPES[name]) \
                == jax_configs.shape_applicable(jax_configs.get_config(arch),
                                                jax_configs.SHAPES[name])
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("kw", [dict(), dict(prefix_len=4, d_model=8, host_id=3)])
def test_token_pipeline_equals_reference(kw):
    """Equal batches for the same (seed, host, step), from the start and
    resumed at a cursor."""
    args = dict(vocab_size=100, seq_len=16, batch_per_host=4, seed=1, **kw)
    for start in (0, 2):
        port, ref = TokenPipeline(start_step=start, **args), JaxTokenPipeline(
            start_step=start, **args)
        try:
            for _ in range(3):
                a, b = next(port), next(ref)
                assert set(a) == set(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
                assert port.cursor() == ref.cursor()
        finally:
            port.close()
            ref.close()
    assert port.cursor() == start + 3


def _leaves_by_layer(model, tree):
    """The JAX param tree's leaves keyed as the port names its parameters:
    layer p * period + o of stack o."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "layers":
            o, group, name = keys[1:]
            for p in range(leaf.shape[0]):
                out[f"layers.{p * model.period + o}.{group}.{name}"] = (
                    tuple(leaf.shape[1:]), leaf.dtype)
        else:
            out[".".join(map(str, keys))] = (tuple(leaf.shape), leaf.dtype)
    return out


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "paligemma-3b", "dbrx-132b"])
def test_specs_equal_eval_shape(arch):
    """token_specs, decode_specs and abstract_params at full width against
    the JAX package's (``eval_shape``, no allocation on either side)."""
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    model = Model(cfg, tp=16, device="meta")
    jmodel = JaxModel(jcfg, tp=16)
    params = specs.abstract_params(model)
    ref = _leaves_by_layer(model, jax_specs.abstract_params(jmodel))
    assert set(params) == set(ref)
    for name, t in params.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype_name(t.dtype)) == (ref[name][0], str(ref[name][1])), name
    for shape_name in ("prefill_32k", "decode_32k"):
        shape = configs.SHAPES[shape_name]
        toks = specs.token_specs(model, shape)
        jtoks = jax_specs.token_specs(jmodel, shape)
        assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in toks.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jtoks.items()}
        token, caches = specs.decode_specs(model, shape)
        jtoken, jcaches = jax_specs.decode_specs(jmodel, shape)
        assert tuple(token.shape) == jtoken.shape and token.dtype == torch.int32
        assert len(caches) == cfg.n_layers
        for o, stack in enumerate(jcaches):
            for k, leaf in stack.items():
                for p in range(leaf.shape[0]):
                    c = caches[p * model.period + o][k]
                    assert c.device.type == "meta"
                    assert (tuple(c.shape), _dtype_name(c.dtype)) == \
                        (tuple(leaf.shape[1:]), str(leaf.dtype)), (o, k, p)


def test_lm_modules_import_without_jax_or_repro():
    code = ("import sys\n"
            "for name in ('jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.configs, repro_torch.data.tokens, repro_torch.launch.specs\n"
            "import repro_torch.models.layers, repro_torch.models.ssd\n"
            "import repro_torch.models.moe, repro_torch.models.transformer\n"
            "import repro_torch.models.params\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.models.transformer import Model\n"
            "import torch\n"
            "m = Model(get_config('smollm-360m').reduced(), device='cpu')\n"
            "m.init(torch.Generator().manual_seed(0))\n"
            "logits, caches = m.prefill(torch.zeros((1, 4), dtype=torch.int64))\n"
            "assert logits.shape == (1, 1, m.V) and torch.isfinite(logits).all()\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "['jax', 'repro']"
