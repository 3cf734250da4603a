"""Weights and caches across the two packages' layouts.

The JAX package keeps a model's layer parameters as one pytree stack per
period offset, each leaf with a leading ``(n_periods,)`` dimension
(``params["layers"][o][group][name][p]`` is layer ``p * period + o``), and
its serving caches the same way. The port keeps one module a layer and one
cache dict a layer. These functions map one layout onto the other on
numpy arrays, so tests can load the reference's weights and optimiser
state into the port and compare the two packages' caches and states.
bfloat16 arrays cross as the ``ml_dtypes`` type that the reference's
numpy arrays carry. ``named_to_reference`` maps tensors by parameter
name into the reference's layout without leaving torch (the train CLI
checkpoints through it).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..optim.adamw import AdamWState
from .transformer import Cache, Model


def _to_torch(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy: a CPU tensor's ``numpy()`` would alias memory that an
    in-place update (the optimiser's) later changes."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's numpy bfloat16 type

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _split(model: Model, i: int):
    """Layer ``i`` -> (period offset, index in that offset's stack)."""
    return i % model.period, i // model.period


def param_name(path: tuple, leaf: str) -> str:
    """The ``named_parameters`` name of a group's leaf (``"layers.3.attn.wq"``)."""
    return ".".join(str(x) for x in path) + "." + leaf


def _reference_leaf(model: Model, tree: Dict[str, Any], path: tuple, leaf: str) -> Any:
    if path[0] == "layers":
        o, p = _split(model, path[1])
        return tree["layers"][o][path[2]][leaf][p]
    return tree[path[0]][leaf]


def named_from_reference(model: Model, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree in the reference's param layout (numpy leaves, or anything
    ``np.asarray`` reads) as CPU tensors by parameter name, the leading
    ``(n_periods,)`` dimension of each layer leaf unstacked."""
    return {param_name(path, leaf): _to_torch(_reference_leaf(model, tree, path, leaf))
            for path, values in model.param_groups(None, "meta") for leaf in values}


def named_to_reference(model: Model, named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors by parameter name (on any one device, ``meta`` too) as a tree
    in the reference's param layout, each layer leaf stacked over the
    ``(n_periods,)`` layers of its period offset."""
    tree: Dict[str, Any] = {"layers": [{} for _ in range(model.period)]}
    stacks: Dict[tuple, List[Dict[str, torch.Tensor]]] = {}
    for path, values in model.param_groups(None, "meta"):
        leaves = {k: named[param_name(path, k)] for k in values}
        if path[0] == "layers":
            o, _p = _split(model, path[1])
            stacks.setdefault((o, path[2]), []).append(leaves)
        else:
            tree[path[0]] = leaves
    for (o, group), per_layer in stacks.items():
        tree["layers"][o][group] = {k: torch.stack([leaf[k] for leaf in per_layer])
                                    for k in per_layer[0]}
    return tree


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return _to_numpy(tree)


def params_from_reference(model: Model, tree: Dict[str, Any]) -> Model:
    """Load the JAX package's param pytree (leaves as numpy arrays, or
    anything ``np.asarray`` reads) into ``model``, unstacking the leading
    ``(n_periods,)`` dimension of each layer leaf. Returns the model."""
    for path, values in model.param_groups(None, "meta"):
        model.group(path).fill_({k: _to_torch(_reference_leaf(model, tree, path, k))
                                 for k in values})
    return model


def params_to_reference(model: Model) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the model's weights as
    the JAX package's param pytree of numpy arrays."""
    named = {k: p.detach().cpu() for k, p in model.named_parameters()}
    return _numpy_tree(named_to_reference(model, named))


def opt_state_from_reference(model: Model, state: Any) -> AdamWState:
    """The JAX package's ``AdamWState(step, m, v)`` (m and v in its param
    layout; numpy leaves, or anything ``np.asarray`` reads) as the port's,
    by parameter name, on the model's device."""
    dev = model.device
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev)
    return AdamWState(step=step,
                      m={k: t.to(dev) for k, t in named_from_reference(model, state.m).items()},
                      v={k: t.to(dev) for k, t in named_from_reference(model, state.v).items()})


def opt_state_to_reference(model: Model, state: AdamWState) -> AdamWState:
    """The inverse of :func:`opt_state_from_reference`: an ``AdamWState``
    (the reference's fields) of numpy leaves, m and v in the reference's
    param layout."""
    def tree(named):
        return _numpy_tree(named_to_reference(
            model, {k: t.detach().cpu() for k, t in named.items()}))

    return AdamWState(step=_to_numpy(state.step), m=tree(state.m), v=tree(state.v))


def caches_to_reference(model: Model, caches: List[Cache]) -> List[Dict[str, np.ndarray]]:
    """The port's per-layer caches in the reference's layout: one dict per
    period offset, each leaf stacked over the ``(n_periods,)`` layers of
    that offset."""
    out: List[Dict[str, np.ndarray]] = []
    for o in range(model.period):
        layers = [caches[p * model.period + o] for p in range(model.n_periods)]
        out.append({k: np.stack([_to_numpy(c[k]) for c in layers]) for k in layers[0]})
    return out
