"""The two packages' loss trajectories side by side, on the CPU: the port's
``make_train_step`` and the JAX package's, from the same seeded weights
(the port's init carried over by ``params_to_reference``), with the train
CLI's ``AdamWConfig`` (lr_peak 3e-3, 10 warm-up steps, the config's
``moment_dtype``) on one fixed random batch repeated. A config's width
and dtypes are kept; its depth and vocabulary are cut to fit a CPU.

Run by hand (minutes at qwen2.5-14b's width; not collected by pytest):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_lm_dynamics.py \\
        --arch qwen2.5-14b --layers 1 --vocab 8192 --batch 8 --seq 64 --steps 7
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.launch.train import make_train_step as jax_train_step
from repro.models.transformer import Model as JaxModel
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro_torch.configs import get_config
from repro_torch.launch.train import make_train_step
from repro_torch.models.params import params_to_reference
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, init_adamw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    over = dict(n_layers=args.layers, vocab_size=args.vocab)
    cfg = dataclasses.replace(get_config(args.arch), **over)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    params = params_to_reference(model)   # a copy: the port's step updates in place
    opt = dict(lr_peak=3e-3, warmup_steps=10, total_steps=args.steps,
               moment_dtype=cfg.opt_state_dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (args.batch, args.seq))
    tokens = tokens.astype(np.int32)

    port_cfg = AdamWConfig(**opt)
    state, step = init_adamw(port_cfg, model), make_train_step(model, port_cfg)
    port = []
    for _ in range(args.steps):
        model, state, met = step(model, state, {"tokens": torch.from_numpy(tokens)})
        port.append(float(met["loss"]))
    print("port", " ".join(f"{x:.4f}" for x in port), flush=True)

    jm = JaxModel(dataclasses.replace(jax_config(args.arch), **over))
    jcfg = JaxAdamWConfig(**opt)
    jstate, jstep = jax_init_adamw(jcfg, params), jax.jit(jax_train_step(jm, jcfg))
    ref = []
    for _ in range(args.steps):
        params, jstate, met = jstep(params, jstate, {"tokens": jnp.asarray(tokens)})
        ref.append(float(met["loss"]))
    print("jax ", " ".join(f"{x:.4f}" for x in ref), flush=True)


if __name__ == "__main__":
    main()
