"""The port's LM dry run (``repro_torch.launch.dryrun``) and partition specs
(``repro_torch.distributed.sharding``) against the JAX package's, on the
CPU, without lowering anything but the FLOP check's reference programs.

* Every parameter spec of the ten configs on the 16x16 and 2x16x16 grids,
  with ``serving`` off and on; the cache specs of both decode shapes, the
  batch specs of every shape and the constrain specs of the four tags
  (the reference's read through a spy in place of
  ``jax.lax.with_sharding_constraint``) equal the reference's on a
  ``jax.sharding.AbstractMesh``, its stacked ``(n_periods,)`` dimension
  dropped.
* ``state_bytes_per_chip``, ``memory.activation_bytes_analytic``,
  ``params_logical/active/padded``, ``seq_sharded`` and ``moe_groups`` of
  all 64 cells equal the reference's ``build_cell`` and ``lower_cell``
  arithmetic exactly.
* Zero-peer shares: device (0, 0)'s share of 1 and 2 periods, on weights
  (and caches) whose other model peers' blocks are zero, against the
  port's unsharded model on the same weights and the device's batch rows,
  for one ``reduced()`` config of each family on 2x2 and 1x4 CPU grids, in
  train, prefill and decode (and the sequence-sharded long decode of the
  two long-context archs): the hidden state entering the final norm, the
  first V/tp logit columns, the caches' local blocks and, for train, the
  loss and the gradient of every block. The unsharded model's loss is the
  share's vocab-parallel one on the first V/tp rows (the log-sum-exp's
  partners stood in by zero on both sides). Tolerance 1e-5 x (1 + max
  |ref|) in float32 (measured <= 3e-6 absolute).
* The collective model by hand for a train, a prefill and a decode cell
  of a reduced dense config on a 2x2 grid, and for the MoE all-to-alls
  and the long decode's softmax combine.
* The analytic global FLOPs against the reference's lowered
  ``cost_analysis()["flops"]`` for smollm-360m's three shapes at 1 and 2
  periods, in a subprocess with 512 host devices and an Auto-axes mesh
  (``jax.make_mesh`` builds Explicit axes now, and ``lower_cell`` then
  fails). The reference is lowered with ``q_chunk`` at the sequence
  length, so its attention and cross-entropy maps run once and XLA counts
  them whole, and for train with ``remat`` off; it checkpoints each
  cross-entropy chunk whatever ``remat`` says, so its train count holds
  the LM head's forward a fourth time, as the port's recompute term does.
  XLA also counts the elementwise operations (softmax, norms,
  activations) that the analytic count leaves out: the analytic count is
  held to [0.95, 1.0] of XLA's.
* The count of what a step needs (``roofline``, ``needed=True``), which
  the bounds use, by hand: causal attention, the SSD recurrence, the
  routed expert pairs, no recompute; it never exceeds the count as run,
  and a record's ``bound_ms`` is built from it.
* ``apply_moe`` takes a share of the experts only when told
  (``local_experts``); mis-shaped expert weights raise.
* Every cell's plan on both grids (the multi-pod grid halves a chip's
  state and, where it halves a device's rows, its FLOPs).
* ``device_block``/``block_shape`` on a tuple axis, ``opt_shardings``,
  the share's constrain hook raising on a wrong block, and R1's dry-run
  roots reaching the timed shares.
* The CLI on the CPU at full width on a cell that fits it (mamba2-370m's
  ``long_500k``): written, read back from the cache, rewritten with
  ``--force``; the default device raises without a card; the modules
  import with ``jax`` and ``repro`` blocked.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices.
The JAX backend is started first, so this process keeps its devices, and
the variable is restored afterwards.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.launch import specs as jax_specs
from repro.models.transformer import Model as JaxModel
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro_torch.configs import SHAPES, ShapeConfig, get_config, shape_applicable
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import DECODE_HEADROOM, abstract_params, decode_specs, token_specs
from repro_torch.models.transformer import Model

SRC = Path(__file__).resolve().parents[1] / "src"
GRIDS = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
G22 = ((2, 2), ("data", "model"))
G14 = ((1, 4), ("data", "model"))
FAMILIES = {"dense": "qwen2.5-14b", "moe": "dbrx-132b", "ssm": "mamba2-370m",
            "hybrid": "jamba-1.5-large-398b", "vlm": "paligemma-3b",
            "audio": "musicgen-large"}
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensor ops: one intra-op thread, so parallel test workers do
    not spin-wait against each other for the cores (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jdr():
    """``repro.launch.dryrun`` with the backend already up, ``XLA_FLAGS``
    restored after its import, and ``make_production_mesh`` answering
    with an ``AbstractMesh`` (no devices needed)."""
    n_devices = len(jax.devices())
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    assert len(jax.devices()) == n_devices
    real = mod.make_production_mesh
    mod.make_production_mesh = lambda multi_pod=False: _mesh(multi_pod)
    yield mod
    mod.make_production_mesh = real


def _mesh(multi_pod):
    shape, names = GRIDS[multi_pod]
    return AbstractMesh(shape, names)


_JAX_PARAMS = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = JaxModel(jax_config(arch), tp=16).init_abstract()
    return _JAX_PARAMS[arch]


def _by_port_name(tree, period, stacked_spec):
    """A reference tree in its param/cache layout (leaves: specs) by the
    port's names, each layer leaf's spec without its stacked dimension."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        spec = tuple(leaf.spec)
        if keys[0] == "layers":
            o, rest = keys[1], keys[2:]
            for i in range(o, stacked_spec, period):
                out[".".join(str(k) for k in ("layers", i, *rest))] = spec[1:]
        else:
            out[".".join(str(k) for k in keys)] = spec
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_the_reference(arch, multi_pod):
    cfg = get_config(arch)
    grid, mesh = GRIDS[multi_pod], _mesh(multi_pod)
    port_abs = abstract_params(Model(cfg, tp=16, device="meta"))
    for serving in (False, True):
        want = _by_port_name(jsh.params_shardings(_jax_params(arch), mesh, serving=serving),
                             cfg.period, cfg.n_layers)
        got = tsh.params_shardings(port_abs, grid, serving=serving)
        assert got == want, (arch, serving)
    assert got["embed.table"] == ("model", None) and got["layers.0.ln1.scale"] == (None,)


def test_blocks_and_opt_specs():
    """``device_block`` cuts device (i, j)'s block of a spec, the names of
    a tuple axis row-major; ``block_shape`` is its shape; the moments
    share the parameter specs and the step is replicated."""
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    grid = ((2, 2, 3), ("pod", "data", "model"))
    spec = (("pod", "data"), "model", None)
    assert tsh.block_shape(t.shape, spec, grid) == (2, 2, 4)
    got = tsh.device_block(t, spec, grid, {"pod": 1, "data": 0, "model": 2})
    assert torch.equal(got, t[4:6, 4:6])
    assert torch.equal(tsh.device_block(t, (), grid, {"pod": 1}), t)
    with pytest.raises(ValueError):
        tsh.block_shape((5, 6), ("data", None), grid)
    p_shard = tsh.params_shardings(abstract_params(Model(get_config("smollm-360m"), tp=16,
                                                         device="meta")), GRIDS[False])
    opt = tdr.opt_shardings(p_shard)
    assert opt.step == () and opt.m == p_shard and opt.v == p_shard
    cfg, shape, grid, model, ss = tdr.build_cell("dbrx-132b", "decode_32k")
    assert (model.tp, model.H, model.KV, cfg.moe_groups, ss) == (16, 48, 16, 16, False)


def _spy_specs(monkeypatch):
    seen = []

    def spy(x, sharding):
        seen.append(tuple(sharding.spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", spy)
    return seen


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_batch_and_constrain_specs_match_the_reference(arch, multi_pod, monkeypatch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    grid, mesh = GRIDS[multi_pod], _mesh(multi_pod)
    model, jmodel = Model(cfg, tp=16, device="meta"), JaxModel(jcfg, tp=16)
    seen = _spy_specs(monkeypatch)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape):
            continue
        ss = shape.global_batch < grid[0][-2]
        if shape.kind == "decode":
            _tok, jc = jax_specs.decode_specs(jmodel, JAX_SHAPES[name])
            want = _by_port_name({"layers": jsh.cache_shardings(mesh, jc, ss)},
                                 cfg.period, cfg.n_layers)
            caches = decode_specs(model, shape)[1]
            got = tsh.cache_shardings(grid, caches, ss)
            assert {f"layers.{i}.{k}": s for i, layer in enumerate(got)
                    for k, s in layer.items()} == want, (name, "caches")
        specs = token_specs(model, shape)
        specs["decode_token"] = torch.empty((shape.global_batch, 1), device="meta")
        jshard, tshard = jsh.batch_shardings(mesh, ss), tsh.batch_shardings(grid, ss)
        for k, t in specs.items():
            assert tshard(k, tuple(t.shape)) == tuple(jshard(k, tuple(t.shape)).spec), (name, k)
        # the four tags at this cell's global shapes and at shapes no axis divides
        b = shape.global_batch // (cfg.microbatches if shape.kind == "train" else 1)
        s = 1 if shape.kind == "decode" else shape.seq_len
        h, p, V = max(cfg.ssm_heads, 1), cfg.ssm_head_dim, cfg.padded_vocab(16)
        for tag, shp in (("hidden", (b, s, cfg.d_model)), ("hidden", (3, 5, cfg.d_model)),
                         ("ssm_heads", (b, s, h, p)), ("ssm_heads", (3, 5, 3, p)),
                         ("ssm_dt", (b, s, h)), ("ssm_dt", (3, s, 3)),
                         ("logits", (b, s, V)), ("logits", (3, 1, 100)),
                         ("other", (b, s))):
            del seen[:]
            x = types.SimpleNamespace(shape=shp, ndim=len(shp))
            assert jsh.make_constrain(mesh, ss)(x, tag) is x
            want = seen[0] if seen else None
            assert tsh.constrain_spec(grid, ss, shp, tag) == want, (name, tag, shp)


def _reference_meta(jdr, arch, shape_name, multi_pod):
    """The reference's meta fields, by its own build_cell, abstract trees,
    _tree_bytes and analytic_activation_bytes, and lower_cell's formula."""
    cfg, shape, mesh, model, ss = jdr.build_cell(arch, shape_name, multi_pod)
    chips = 512 if multi_pod else 256
    p_abs = _jax_params(arch)
    state = jdr._tree_bytes(p_abs)
    if shape.kind == "train":
        state += jdr._tree_bytes(jax_specs.abstract_opt_state(
            model, JaxAdamWConfig(moment_dtype=cfg.opt_state_dtype)))
    elif shape.kind == "decode":
        state += jdr._tree_bytes(jax_specs.decode_specs(model, shape)[1])
    return {"seq_sharded": ss, "moe_groups": cfg.moe_groups,
            "params_logical": cfg.param_count(), "params_active": cfg.active_param_count(),
            "params_padded": cfg.param_count(logical=False, tp=16),
            "state_bytes_per_chip": state / chips,
            "activation_bytes_analytic": jdr.analytic_activation_bytes(
                jax_config(arch), shape, mesh, None),
            "chips": chips, "kind": shape.kind}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_meta_matches_the_reference(jdr, multi_pod):
    cells = tdr.all_cells(multi_pod)
    assert len(cells) == 32
    for arch, shape_name in cells:
        got = tdr.cell_meta(arch, shape_name, multi_pod)
        got["activation_bytes_analytic"] = got["memory"]["activation_bytes_analytic"]
        want = _reference_meta(jdr, arch, shape_name, multi_pod)
        assert {k: got[k] for k in want} == want, (arch, shape_name)
        assert got["peak_bytes_per_chip"] == (want["state_bytes_per_chip"]
                                              + want["activation_bytes_analytic"])
        assert got["mesh"] == ("2x16x16" if multi_pod else "16x16")


# -- zero-peer shares ----------------------------------------------------------


def _zero_outside(t, ranges):
    mask = torch.ones((), dtype=torch.bool)
    for dim, r in enumerate(ranges):
        if r is None:
            continue
        m = torch.zeros(t.shape[dim], dtype=torch.bool)
        for a, b in r:
            m[a:b] = True
        shape = [1] * t.dim()
        shape[dim] = -1
        mask = mask & m.reshape(shape)
    return t * mask.to(t.dtype)


def _share_caches(caches, cfg, w, seq_block):
    """Device (0, 0)'s decode caches from the whole layer's over its batch
    rows: the local heads and channels, and with ``seq_block`` (a
    sequence-sharded cache) the first rows of k and v."""
    out = []
    for layer in caches:
        blk = {}
        for name, t in layer.items():
            if seq_block is not None and name in ("k", "v"):
                t = t[:, :seq_block]
            blk[name] = tdr.take(t, tdr.share_ranges(name, t.shape, cfg, w)).contiguous()
        out.append(blk)
    return out


def _close(got, want, what):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= TOL * (1.0 + float(want.abs().max())), (what, err)


CELL_SHAPES = {"train": ShapeConfig("t", 16, 4, "train"),
               "prefill": ShapeConfig("p", 16, 4, "prefill"),
               "decode": ShapeConfig("d", 16, 4, "decode"),
               "long": ShapeConfig("l", 16, 1, "decode")}


def _zero_peer_case(arch, grid, kind, n_periods):
    cfg, shape, grid, ss = tdr.cell_config(get_config(arch).reduced(), CELL_SHAPES[kind],
                                           grid=grid)
    scfg, b_call, b_l = tdr.share_cfg(cfg, shape, grid, ss, n_periods * cfg.period)
    ref = Model(scfg, tp=grid[0][-1], device="cpu").init(torch.Generator().manual_seed(0))
    share = tdr.ShareModel(scfg, grid, ss, b_call, device="cpu")
    named = dict(ref.named_parameters())
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(_zero_outside(p, share.blocks[k][1]))
    share.load(named)
    g = torch.Generator().manual_seed(1)
    M = scfg.microbatches if kind == "train" else 1
    P = cfg.prefix_len if cfg.frontend != "none" else 0
    s = 1 if shape.kind == "decode" else shape.seq_len - P
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (M * b_l, s), generator=g,
                                     dtype=torch.int32)}
    if P and shape.kind != "decode":
        batch["prefix_embeds"] = torch.randn((M * b_l, P, cfg.d_model), generator=g)
    hidden = {}
    for tag, m in (("ref", ref), ("share", share)):
        m.final_norm.register_forward_pre_hook(
            lambda _mod, args, tag=tag: hidden.__setitem__(tag, args[0]))
    w, V_l = share.local, share.local.V

    def local(name, t):
        return tdr.take(t, tdr.share_ranges(name, t.shape, cfg, w))

    if kind == "train":
        ref.xent_chunk = lambda wt, x, t, m: tdr.vocab_parallel_xent_chunk(wt[:, :V_l], x, t, m)
        loss, grads = tdr.train_share(share, batch)
        ref_loss, ref_grads = tdr.loss_and_grads(ref, batch, M)
        _close(loss, ref_loss, "loss")
        assert set(grads) == set(ref_grads)
        for k, gk in grads.items():
            _close(gk, tdr.take(ref_grads[k], share.blocks[k][1]), k)
    elif kind == "prefill":
        logits, caches = tdr.prefill_share(share, batch)
        ref_logits, ref_caches = ref.prefill(batch["tokens"], batch.get("prefix_embeds"))
        _close(logits, ref_logits[..., :V_l], "logits")
        for i, (c, rc) in enumerate(zip(caches, ref_caches)):
            for k in c:
                _close(c[k], local(k, rc[k]), f"cache {i} {k}")
    else:
        full = ref.init_caches(b_l, shape.seq_len + DECODE_HEADROOM)
        for c in full:
            for k, t in c.items():
                if k == "len":
                    t.fill_(5)              # live rows 0..5 lie in device 0's block
                else:
                    t.copy_(_zero_outside(torch.randn(t.shape, generator=g),
                                          tdr.share_ranges(k, t.shape, cfg, w)))
        seq_block = (shape.seq_len + DECODE_HEADROOM) // grid[0][0] if ss else None
        caches = _share_caches(full, cfg, w, seq_block)
        logits, caches = tdr.decode_share(share, batch["tokens"], caches)
        ref_logits, ref_caches = ref.decode_step(batch["tokens"], full)
        _close(logits, ref_logits[..., :V_l], "logits")
        for i, (c, rc) in enumerate(zip(caches, ref_caches)):
            for k in c:
                want = local(k, rc[k])
                if seq_block is not None and k in ("k", "v"):
                    want = want[:, :seq_block]
                _close(c[k], want, f"cache {i} {k}")
    _close(hidden["share"], hidden["ref"], "hidden")


@pytest.mark.parametrize("grid", [G22, G14], ids=["2x2", "1x4"])
@pytest.mark.parametrize("family,kind", [
    (family, kind) for family in FAMILIES for kind in ("train", "prefill", "decode")
] + [("ssm", "long"), ("hybrid", "long")])   # long_500k: the long-context archs
def test_zero_peer_share_equals_the_unsharded_model(family, kind, grid):
    arch = FAMILIES[family]
    for n_periods in (1, 2):
        _zero_peer_case(arch, grid, kind, n_periods)


def test_share_checks_its_block_shapes():
    """The share's constrain hook raises on an activation that is not its
    block: here the whole batch where the 2x2 grid gives half of it."""
    cfg, shape, grid, ss = tdr.cell_config(get_config("smollm-360m").reduced(),
                                           CELL_SHAPES["prefill"], grid=G22)
    scfg, b_call, b_l = tdr.share_cfg(cfg, shape, grid, ss, cfg.period)
    assert (b_call, b_l) == (4, 2)
    share = tdr.ShareModel(scfg, grid, ss, b_call, device="cpu").randomize(
        torch.Generator().manual_seed(0))
    tokens = torch.zeros((b_l, 16), dtype=torch.int32)
    tdr.prefill_share(share, {"tokens": tokens})
    with pytest.raises(ValueError, match="hidden"):
        tdr.prefill_share(share, {"tokens": torch.zeros((b_call, 16), dtype=torch.int32)})


# -- the collective model and the FLOPs ------------------------------------------


def _ring(kind, size, g):
    return (2.0 if kind == "all-reduce" else 1.0) * size * (g - 1) / g


def test_collective_model_by_hand():
    """smollm-360m reduced (d 64, 4 heads padded from 4, kv 2, hd 16,
    d_ff 128, V 256, float32, 2 layers) on the 2x2 grid: device (0, 0)'s
    gathered blocks per layer are wq 64x32, wk and wv 64x16, wo 32x64, the
    MLP's 64x64 x2 and 64x64, two norms of 64; the embedding 128x64, the
    LM head 64x128 and the final norm 64."""
    cfg = get_config("smollm-360m").reduced()
    layer_fs = (64 * 32 + 2 * 64 * 16 + 32 * 64 + 3 * 64 * 64) * 4.0
    layer_rep = 2 * 64 * 4.0
    top_fs, top_rep = (128 * 64 + 64 * 128) * 4.0, 64 * 4.0
    for kind, b, s in (("train", 4, 16), ("prefill", 4, 16), ("decode", 4, 16)):
        plan = tdr.plan_cell(cfg, ShapeConfig(kind, s, b, kind), grid=G22)
        T = 2 * (1 if kind == "decode" else s)         # device rows x tokens
        hidden = T * 64 * 4.0
        fs = 2 * layer_fs + top_fs
        passes = 2 if kind == "train" else 1
        want = {"all-gather": passes * _ring("all-gather", fs, 2),
                "reduce-scatter": _ring("reduce-scatter", fs, 2) if kind == "train" else 0.0,
                # the embedding's sum and two per layer (wo, w_down), per pass
                "all-reduce": passes * 5 * _ring("all-reduce", hidden, 2),
                "all-to-all": 0.0}
        if kind == "train":
            want["all-reduce"] += _ring("all-reduce", 2 * layer_rep + top_rep, 2)
            want["all-reduce"] += 3 * _ring("all-reduce", T * 4.0, 2) + \
                _ring("all-reduce", hidden, 2)
        got = plan["collectives_by_kind_extrap"]
        assert got == pytest.approx(want, rel=1e-12), kind
        assert plan["collective_wire_bytes_extrap"] == pytest.approx(sum(want.values()))
    # the MoE dispatch and combine: dbrx reduced (E 4, top 2, d 64) on 1x4,
    # one group of 4 x 16 tokens, C = ceil(8 x 64 x 2 / 4) = 256
    moe = get_config("dbrx-132b").reduced()
    plan = tdr.plan_cell(moe, ShapeConfig("p", 16, 4, "prefill"), grid=G14)
    buf = 1 * 4 * 256 * 64 * 4.0
    assert plan["collectives_by_kind_extrap"]["all-to-all"] == pytest.approx(
        moe.n_layers * 2 * _ring("all-to-all", buf, 4))
    # the sequence-sharded decode (batch 1 < data 2): one token, and per
    # attention layer the softmax combine of 4 / 2 heads over the 2 shards
    plan = tdr.plan_cell(cfg, ShapeConfig("l", 16, 1, "decode"), grid=G22)
    assert plan["seq_sharded"]
    hidden = 1 * 64 * 4.0
    want = {"all-gather": _ring("all-gather", 2 * layer_fs + top_fs, 2),
            "reduce-scatter": 0.0, "all-to-all": 0.0,
            "all-reduce": 5 * _ring("all-reduce", hidden, 2)
            + 2 * _ring("all-reduce", 1 * 2 * (16 + 2) * 4.0, 2)}
    assert plan["collectives_by_kind_extrap"] == pytest.approx(want, rel=1e-12)


_FLOPS_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as dr
from repro.launch.dryrun_rpq import _cost_dict
dr.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
get = dr.get_config
out = {}
for shape in ("decode_32k", "prefill_32k", "train_4k"):
    seq = dr.SHAPES[shape].seq_len
    dr.get_config = lambda name: dataclasses.replace(get(name), q_chunk=seq, remat=False)
    for n in (1, 2):
        lowered, _meta = dr.lower_cell("smollm-360m", shape, False, scan_unroll=True,
                                       n_layers=n)
        out[f"{shape}/{n}"] = _cost_dict(lowered.cost_analysis())["flops"]
print(json.dumps(out))
"""


def test_global_flops_match_the_reference_lowering():
    proc = subprocess.run([sys.executable, "-c", _FLOPS_SCRIPT], capture_output=True,
                          text=True, timeout=600,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    xla = json.loads(proc.stdout.strip().splitlines()[-1])
    for shape_name in ("decode_32k", "prefill_32k", "train_4k"):
        shape = SHAPES[shape_name]
        cfg = dataclasses.replace(get_config("smollm-360m"), q_chunk=shape.seq_len,
                                  remat=False)
        for n in (1, 2):
            flops, recompute = rl.step_flops(cfg, shape, rl.widths(cfg, 16, local=False),
                                             shape.global_batch, 1, n)
            ratio = (flops + recompute) / xla[f"{shape_name}/{n}"]
            assert 0.95 <= ratio <= 1.0, (shape_name, n, ratio)


def test_needed_flops_by_hand():
    """smollm-360m reduced (d 64, 4 heads, kv 2, hd 16, d_ff 128, V 256,
    2 layers), 4 x 16 tokens: per layer the projections 2 T d (H + 2 KV)
    hd + 2 T H hd d, causal QK and PV 4 b H hd s(s+1)/2 and the MLP 2 T 3
    d f; the LM head on the last position (prefill) or the 15 the loss
    reads (train, 3x the forward). dbrx reduced (E 4, top 2, d_ff 128) on
    given kept pairs; mamba2 reduced's recurrence 4 T h n p."""
    cfg = get_config("smollm-360m").reduced()
    b, s, d, H, KV, hd, f, V = 4, 16, 64, 4, 2, 16, 128, 256
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.n_layers) == (d, H, KV, hd, f, V, 2)
    T = b * s
    layer = (2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d
             + 4 * b * H * hd * s * (s + 1) / 2 + 2 * T * 3 * d * f)
    w = rl.logical_widths(cfg)
    pre = rl.step_flops(cfg, ShapeConfig("p", s, b, "prefill"), w, b, 1, 2, needed=True)
    assert pre == (2 * layer + 2 * b * d * V, 0.0)
    train = rl.step_flops(cfg, ShapeConfig("t", s, b, "train"), w, b, 1, 2, needed=True)
    assert train == (3 * (2 * layer + 2 * b * (s - 1) * d * V), 0.0)
    moe = get_config("dbrx-132b").reduced()
    wm = rl.logical_widths(moe)
    base = rl.forward_flops(moe, ShapeConfig("p", s, b, "prefill"), wm, b, 1, 1,
                            needed=True, pairs=[0])["layers"]
    got = rl.forward_flops(moe, ShapeConfig("p", s, b, "prefill"), wm, b, 1, 1,
                           needed=True, pairs=[100])["layers"]
    assert got - base == 2 * 3 * moe.d_model * moe.d_ff * 100
    even = rl.forward_flops(moe, ShapeConfig("p", s, b, "prefill"), wm, b, 1, 1,
                            needed=True)["layers"]
    assert even - base == 2 * 3 * moe.d_model * moe.d_ff * T * moe.experts_per_token
    ssm = get_config("mamba2-370m").reduced()
    ws = rl.logical_widths(ssm)
    n, p, h, di = ssm.ssm_state, ssm.ssm_head_dim, ssm.ssm_heads, ssm.d_inner
    one = rl.forward_flops(ssm, ShapeConfig("p", s, b, "prefill"), ws, b, 1, 1,
                           needed=True)["layers"]
    assert one == (2 * T * ssm.d_model * (2 * di + 2 * n + h) + 2 * T * di * ssm.d_model
                   + 4 * T * h * n * p)


def test_bound_uses_what_the_step_needs(tmp_path):
    """Every cell of both grids needs no more FLOPs than its share runs
    (with the recompute); smollm-360m's train_4k about half of it (the
    causal half and the remat's two extra forwards). A record's bound is
    the larger of the needed FLOPs and the share's bytes over the peaks."""
    for mp in (False, True):
        for arch, shape_name in tdr.all_cells(mp):
            r = tdr.plan_cell(arch, shape_name, mp)
            assert 0 < r["device_needed_flops_extrap"] <= \
                (r["device_flops_extrap"] + r["remat_flops_extrap"]) * (1 + 1e-12), \
                (arch, shape_name, mp)
    r = tdr.plan_cell("smollm-360m", "train_4k")
    ratio = r["device_needed_flops_extrap"] / (r["device_flops_extrap"] + r["remat_flops_extrap"])
    assert 0.45 < ratio < 0.5
    cfg = get_config("smollm-360m").reduced()
    rec = tdr.run_cell(cfg, ShapeConfig("t", 16, 4, "train"), device="cpu",
                       out_dir=tmp_path, grid=G22)
    t_ops = rec["device_needed_flops_extrap"] / rl.PEAK_BF16_FLOPS
    t_bytes = rec["share_bytes"] / rl.PEAK_BYTES
    assert rec["bound_ms"] == max(t_ops, t_bytes) * 1e3
    assert rec["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")


def test_moe_shares_experts_only_when_told():
    """Expert weights for fewer experts than the router's raise unless
    ``local_experts`` says so; with it, experts [0, E_l) give the layer's
    output where the other experts' weights are zero."""
    from repro_torch.models.moe import apply_moe, init_moe

    g = torch.Generator().manual_seed(0)
    full = init_moe(g, 16, 32, 4, dtype=torch.float32, device="cpu")
    x = torch.randn((2, 8, 16), generator=g)
    part = {k: v if k == "router" else v[:2] for k, v in full.items()}
    with pytest.raises(ValueError, match="expected 4"):
        apply_moe(part, x, top_k=2)
    with pytest.raises(ValueError, match="expected 3"):
        apply_moe(part, x, top_k=2, local_experts=3)
    zeroed = {k: v if k == "router" else torch.cat([v[:2], torch.zeros_like(v[2:])])
              for k, v in full.items()}
    for groups in (1, 2):
        y, aux = apply_moe(part, x, top_k=2, n_groups=groups, local_experts=2)
        want, want_aux = apply_moe(zeroed, x, top_k=2, n_groups=groups)
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
        torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)


def test_plans_of_both_grids():
    """Every cell plans on both grids. The 2x16x16 grid halves the state a
    chip holds; where it halves a device's rows, it halves the device's
    FLOPs too. The whole step's FLOPs are the same on both. MoE is the
    exception to both, by as much as the capacity's rounding up: the
    multi-pod grid has twice the dispatch groups, each half the tokens."""
    for arch, shape_name in tdr.all_cells(False):
        pod = tdr.plan_cell(arch, shape_name, False)
        multi = tdr.plan_cell(arch, shape_name, True)
        if get_config(arch).n_experts:
            assert multi["global_flops_extrap"] >= pod["global_flops_extrap"]
        else:
            assert multi["global_flops_extrap"] == pod["global_flops_extrap"], (arch, shape_name)
        assert multi["state_bytes_per_chip"] == pod["state_bytes_per_chip"] / 2
        for r in (pod, multi):
            assert r["device_flops_extrap"] * r["chips"] >= r["global_flops_extrap"] * (1 - 1e-9)
            assert r["collective_wire_bytes_extrap"] >= 0
        if pod["local_batch_per_call"] == 2 * multi["local_batch_per_call"]:
            half = pod["device_flops_extrap"] / 2
            if get_config(arch).n_experts:
                assert multi["device_flops_extrap"] >= half * (1 - 1e-9), (arch, shape_name)
            else:
                assert multi["device_flops_extrap"] == pytest.approx(half, rel=1e-9), \
                    (arch, shape_name)


# -- the CLI -----------------------------------------------------------------------


def test_cli_writes_reads_back_and_forces(tmp_path):
    """mamba2-370m's long_500k at full width fits the CPU (a device's state
    is a few MB): the CLI writes its record, the next call reads it back,
    ``--force`` writes it anew."""
    args = ["--arch", "mamba2-370m", "--shape", "long_500k", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as done:
        tdr.main(args)
    assert done.value.code == 0
    path = tmp_path / "mamba2-370m__long_500k__pod.json"
    r = json.loads(path.read_text())
    assert r["ok"] and r["outputs_finite"] and r["seq_sharded"]
    assert r["device"] == "cpu" and r["device_ms_extrap"] is None and r["fits_hbm"] is None
    assert r["device_state_bytes"] > 0 and r["bound_ms"] > 0
    path.write_text(path.read_text().replace('"ok": true', '"ok": "cached"'))
    assert tdr.run_cell("mamba2-370m", "long_500k", out_dir=tmp_path,
                        device="cpu")["ok"] == "cached"
    with pytest.raises(SystemExit):
        tdr.main(args + ["--force"])
    assert json.loads(path.read_text())["ok"] is True


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        assert tdr.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.run_cell("mamba2-370m", "long_500k", out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--out-dir", str(tmp_path)])


def test_modules_import_without_jax_or_repro():
    code = ("import sys\n"
            "for name in ('jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import repro_torch.distributed.sharding, repro_torch.launch.roofline\n"
            "import repro_torch.launch.dryrun as d\n"
            "r = d.cell_meta('smollm-360m', 'decode_32k')\n"
            "assert r['state_bytes_per_chip'] > 0\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro')))\n"
            "print(repr(__import__('os').environ.get('XLA_FLAGS')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-2:] == ["['jax', 'repro']", "None"]


@pytest.mark.parametrize("root,share", [("lower_cell.prefill_step", "prefill_share"),
                                        ("lower_cell.serve_step", "decode_share")])
def test_r1_scopes_the_timed_shares(root, share):
    """The JAX dry run's serving roots map to the port's share functions
    too, and R1's call graph reaches through them to the share's own
    embedding and inputs."""
    from repro_torch.analysis.analyzer import load_project
    from repro_torch.analysis.rules.r1_dispatch_syncs import DISPATCH_ROOTS

    keys = DISPATCH_ROOTS[("repro.launch.dryrun", root)]
    mod = "repro_torch.launch.dryrun"
    assert (mod, share) in keys
    graph = load_project([str(SRC / "repro_torch")]).callgraph(keys)
    for key in ((mod, share), (mod, "ShareModel._embed_inputs"),
                (mod, "ShareEmbedding.forward"), (mod, "ShareMoE.forward")):
        assert key in graph.reachable, key
