"""Weights and caches across the two packages' layouts.

The JAX package keeps a model's layer parameters as one pytree stack per
period offset, each leaf with a leading ``(n_periods,)`` dimension
(``params["layers"][o][group][name][p]`` is layer ``p * period + o``), and
its serving caches the same way. The port keeps one module a layer and one
cache dict a layer. These functions map one layout onto the other on
numpy arrays, so tests can load the reference's weights into the port and
compare the two packages' caches. bfloat16 arrays cross as the
``ml_dtypes`` type that the reference's numpy arrays carry.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .transformer import Cache, Model


def _to_torch(a: Any) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's numpy bfloat16 type

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _split(model: Model, i: int):
    """Layer ``i`` -> (period offset, index in that offset's stack)."""
    return i % model.period, i // model.period


def params_from_reference(model: Model, tree: Dict[str, Any]) -> Model:
    """Load the JAX package's param pytree (leaves as numpy arrays, or
    anything ``np.asarray`` reads) into ``model``, unstacking the leading
    ``(n_periods,)`` dimension of each layer leaf. Returns the model."""
    for path, _values in model.param_groups(None, "meta"):
        if path[0] == "layers":
            o, p = _split(model, path[1])
            leaves = {k: v[p] for k, v in tree["layers"][o][path[2]].items()}
        else:
            leaves = tree[path[0]]
        model.group(path).fill_({k: _to_torch(v) for k, v in leaves.items()})
    return model


def params_to_reference(model: Model) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the model's weights as
    the JAX package's param pytree of numpy arrays."""
    tree: Dict[str, Any] = {"layers": [{} for _ in range(model.period)]}
    stacks: Dict[tuple, List[Dict[str, np.ndarray]]] = {}
    for path, _values in model.param_groups(None, "meta"):
        leaves = {k: _to_numpy(v) for k, v in model.group(path).named_parameters()}
        if path[0] == "layers":
            o, _p = _split(model, path[1])
            stacks.setdefault((o, path[2]), []).append(leaves)
        else:
            tree[path[0]] = leaves
    for (o, group), per_layer in stacks.items():
        tree["layers"][o][group] = {k: np.stack([leaf[k] for leaf in per_layer])
                                    for k in per_layer[0]}
    return tree


def caches_to_reference(model: Model, caches: List[Cache]) -> List[Dict[str, np.ndarray]]:
    """The port's per-layer caches in the reference's layout: one dict per
    period offset, each leaf stacked over the ``(n_periods,)`` layers of
    that offset."""
    out: List[Dict[str, np.ndarray]] = []
    for o in range(model.period):
        layers = [caches[p * model.period + o] for p in range(model.n_periods)]
        out.append({k: np.stack([_to_numpy(c[k]) for c in layers]) for k in layers[0]})
    return out
