"""Training: the step builder plus a runnable CLI for end-to-end
training with checkpoint/restart and straggler monitoring. The port of
``repro.launch.train``.

CLI (the card by default; ``--device cpu`` for the CPU; reduced config
unless ``--full-config``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Its checkpoints hold the reference's layout, ``{"params", "opt"}`` with
the weights and both moments stacked per period offset, so the JAX
package's ``ckpt.restore`` reads them into its own trees.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Tuple

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.params import named_to_reference
from ..models.transformer import Model
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update, init_adamw

Batch = Dict[str, torch.Tensor]


def _grads(model: Model, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, its gradient by parameter name); a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives."""
    params = dict(model.named_parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def loss_and_grads(model: Model, batch: Batch, microbatches: int = 1,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train step's loss and gradients. At ``microbatches`` M > 1 the
    global batch is split into M chunks run one after another, shrinking
    the activation live set M-fold at the cost of M sequential passes;
    grads accumulate in bf16 whatever the parameters' dtype (mean of
    means; error <= 2^-8 relative, dominated by bf16 gradient noise
    itself), the loss in float32."""
    M = microbatches
    if M <= 1:
        return _grads(model, batch)
    mbs = {k: x.reshape((M, x.shape[0] // M) + x.shape[1:]) for k, x in batch.items()}
    grads = {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
             for k, p in model.named_parameters()}
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(M):
        loss_i, g_i = _grads(model, {k: x[i] for k, x in mbs.items()})
        for k, g in g_i.items():
            grads[k] += g.to(torch.bfloat16).div_(M)
        loss = loss + loss_i / M
        del g_i
    return loss, grads


def make_train_step(model: Model, opt_cfg: AdamWConfig) -> Callable:
    """Single step with optional gradient accumulation over
    ``cfg.microbatches`` (:func:`loss_and_grads`), then AdamW. The step
    updates the model's parameters and ``opt_state`` in place and returns
    (model, opt_state, metrics) with ``loss``, ``lr`` and ``grad_norm`` as
    device scalars: it makes no host sync."""
    M = model.cfg.microbatches

    def train_step(model: Model, opt_state: AdamWState, batch: Batch):
        loss, grads = loss_and_grads(model, batch, M)
        _params, opt_state, metrics = adamw_update(opt_cfg, model, grads, opt_state)
        return model, opt_state, {**metrics, "loss": loss}

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(model: Model, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(batch)

    return eval_step


def checkpoint_tree(model: Model, opt_state: AdamWState) -> Dict[str, object]:
    """``{"params", "opt"}`` in the reference's layout, on the host."""
    def tree(named):
        return named_to_reference(model, {k: t.detach().cpu() for k, t in named.items()})

    return {"params": tree(dict(model.named_parameters())),
            "opt": AdamWState(opt_state.step.cpu(), tree(opt_state.m), tree(opt_state.v))}


# ---------------------------------------------------------------------------
# the end-to-end CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> Tuple[Model, AdamWState]:
    """The CLI; returns the trained model and its optimiser state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full arch config (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    model = Model(cfg, tp=1, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=10, total_steps=args.steps,
                          moment_dtype=cfg.opt_state_dtype)
    opt_state = init_adamw(opt_cfg, model)
    step_fn = make_train_step(model, opt_cfg)

    from ..data.tokens import TokenPipeline

    pipe = TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_per_host=args.batch,
        prefix_len=cfg.prefix_len if cfg.frontend != "none" else 0,
        d_model=cfg.d_model,
    )

    from ..distributed.fault import StragglerMonitor

    monitor = StragglerMonitor()
    losses = []
    t_start = time.monotonic()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
        t0 = time.monotonic()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        monitor.observe(step, time.monotonic() - t0)
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}"
                  f"  gnorm {float(metrics['grad_norm']):.3f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            from ..checkpoint import ckpt

            ckpt.async_save(args.ckpt_dir, step + 1, checkpoint_tree(model, opt_state),
                            extra={"step": step + 1, "cursor": pipe.cursor()})
    if args.ckpt_dir:
        from ..checkpoint import ckpt

        ckpt.wait_pending(args.ckpt_dir)
    wall = time.monotonic() - t_start
    print(f"done: {args.steps} steps in {wall:.1f}s "
          f"({args.steps * args.batch * args.seq / wall:.0f} tok/s); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers: {len(monitor.stragglers)}")
    pipe.close()
    return model, opt_state


if __name__ == "__main__":
    main()
