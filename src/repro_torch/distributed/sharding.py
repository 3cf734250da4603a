"""Partition specs for every array family, per grid flavor. The port of
``repro.distributed.sharding``.

A grid is the ``(shape, axis_names)`` pair that
:func:`repro_torch.launch.mesh.make_production_grid` returns:

    single-pod:  (16, 16)      over ('data', 'model')
    multi-pod:   (2, 16, 16)   over ('pod', 'data', 'model')

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names (the dimension split over their product, the first the slowest) or
None (whole). It is what ``tuple(PartitionSpec(...))`` of the reference
gives, a one-name tuple written as the name. Nothing here touches a device:
the dry run (``repro_torch.launch.dryrun``) reads the specs to size one
device's blocks and :func:`device_block` cuts them.

FSDP axis = ('data',) or ('pod', 'data'): parameters and optimizer moments
are additionally sharded over the data-parallel axis (ZeRO-3 style).

Param rules, keyed by the port's parameter names (``"layers.3.attn.wq"``;
the reference's stacked leading ``(n_periods,)`` dimension, never sharded,
has no counterpart here):
    embed.table      (V, d)        V->model, d->fsdp
    lm_head.w        (d, V)        d->fsdp,  V->model
    attn wq/wk/wv    (d, H*hd)     d->fsdp,  cols->model
    attn wo          (H*hd, d)     rows->model, d->fsdp
    mlp w_gate/up    (d, f)        d->fsdp,  f->model
    mlp w_down       (f, d)        f->model, d->fsdp
    moe router       (d, E)        replicated
    moe w_*          (E, d, f)     E->model, d->fsdp (expert parallelism)
    ssd w_in         (d, ch)       d->fsdp,  ch->model
    ssd w_out        (di, d)       di->model, d->fsdp
    biases/norms/small             replicated
each axis only where it divides the dimension.

Activation rules (constrain tags):
    hidden     (b, s, d)     b->batch axes; s->batch axes (long-context, b=1)
    ssm_heads  (b, s, h, p)  b (or s) -> batch axes, h->model
    ssm_dt     (b, s, h)     b->batch axes, h->model
    logits     (b, s, V)     b->batch axes, V->model
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Grid = Tuple[Tuple[int, ...], Tuple[str, ...]]
Axes = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Axes], ...]

#: parameter leaves that every device holds whole
REPLICATED = ("scale", "norm_scale", "dt_bias", "A_log", "D", "conv_b", "bq", "bk", "bv")


def axis_sizes(grid: Grid) -> Dict[str, int]:
    shape, names = grid
    return dict(zip(names, shape))


def _names(axes: Axes) -> Tuple[str, ...]:
    return axes if isinstance(axes, tuple) else (axes,)


def _norm(axes: Axes) -> Axes:
    """A one-name tuple as its name, as ``PartitionSpec`` writes it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def fsdp_axes(grid: Grid) -> Tuple[str, ...]:
    if "pod" in grid[1]:
        return ("pod", "data")
    return ("data",)


def batch_axes(grid: Grid) -> Tuple[str, ...]:
    return fsdp_axes(grid)


def axes_size(grid: Grid, axes: Optional[Axes]) -> int:
    """Devices a dimension is split over (1 for None)."""
    if axes is None:
        return 1
    sizes = axis_sizes(grid)
    return math.prod(sizes[a] for a in _names(axes))


def _divisible(dim: Optional[int], grid: Grid, axes: Axes) -> bool:
    if dim is None:
        return False
    total = axes_size(grid, axes)
    return dim % total == 0 and dim >= total


def _spec(*dims: Optional[Axes]) -> Spec:
    return tuple(None if d is None else _norm(d) for d in dims)


def param_spec(name: str, shape: Sequence[int], grid: Grid) -> Spec:
    """The spec of one parameter, by its name and shape."""
    fs = fsdp_axes(grid)
    leaf = name.split(".")[-1]
    dims = tuple(shape)

    def on(dim: int, axes: Axes) -> Optional[Axes]:
        return axes if _divisible(dim, grid, axes) else None

    if leaf in REPLICATED or leaf == "router":
        return (None,) * len(dims)
    if leaf == "conv_w":
        return _spec(None, on(dims[-1], "model"))
    if leaf == "table":                                     # embedding (V, d)
        return _spec(on(dims[0], "model"), on(dims[1], fs))
    if name.startswith("lm_head"):                          # (d, V)
        return _spec(on(dims[0], fs), on(dims[1], "model"))
    if leaf in ("w_gate", "w_up", "w_down") and len(dims) == 3:  # MoE (E, d, f)
        return _spec(on(dims[0], "model"), on(dims[1], fs), None)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w"):  # (d, cols)
        return _spec(on(dims[0], fs), on(dims[1], "model"))
    if leaf in ("wo", "w_down", "w_out"):                   # (rows, d)
        return _spec(on(dims[0], "model"), on(dims[1], fs))
    return (None,) * len(dims)


def _drop_fsdp(spec: Spec) -> Spec:
    return tuple(None if d is not None and set(_names(d)) & {"data", "pod"} else d
                 for d in spec)


def params_shardings(abstract_params: Mapping[str, torch.Tensor], grid: Grid,
                     serving: bool = False) -> Dict[str, Spec]:
    """The spec of every parameter, by name (``abstract_params``: the
    tensors by name, meta ones will do).

    serving=True drops the FSDP axes: parameters replicate across data and
    only tensor-parallel sharding remains. The reference's note: decode
    steps are otherwise dominated by per-step FSDP parameter all-gathers,
    and serving has no optimizer state, so replication costs only
    params/TP of memory."""
    out = {}
    for name, t in abstract_params.items():
        spec = param_spec(name, t.shape, grid)
        out[name] = _drop_fsdp(spec) if serving else spec
    return out


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def constrain_spec(grid: Grid, seq_sharded: bool, shape: Sequence[int],
                   tag: str) -> Optional[Spec]:
    """The spec the reference's ``make_constrain`` pins an activation of
    this (global) shape and tag to; None where it leaves it alone. ``()``
    is the reference's ``P()``: replicated."""
    ba = batch_axes(grid)
    nd = len(shape)

    def on(dim: int, axes: Axes) -> Optional[Axes]:
        return axes if _divisible(dim, grid, axes) else None

    if tag == "hidden" and nd == 3:
        b, s, _d = shape
        if seq_sharded:
            return _spec(None, ba, None) if _divisible(s, grid, ba) else ()
        return _spec(ba, None, None) if _divisible(b, grid, ba) else ()
    if tag == "ssm_heads" and nd == 4:
        b, s, h, _p = shape
        if seq_sharded:
            return _spec(None, on(s, ba), on(h, "model"), None)
        return _spec(on(b, ba), None, on(h, "model"), None)
    if tag == "ssm_dt" and nd == 3:
        b, _s, h = shape
        return _spec(None if seq_sharded else on(b, ba), None, on(h, "model"))
    if tag == "logits" and nd == 3:
        b, _s, v = shape
        return _spec(None if seq_sharded else on(b, ba), None, on(v, "model"))
    return None


class ShareDims(NamedTuple):
    """The global sizes a share's activations stand for: the batch of one
    call (a microbatch in training), the SSD heads and the padded
    vocabulary. The sequence is taken as the activation's own."""
    batch: int
    ssm_heads: int
    vocab: int


def _global_shape(shape: Sequence[int], tag: str, dims: ShareDims) -> Tuple[int, ...]:
    g = list(shape)
    g[0] = dims.batch
    if tag in ("ssm_heads", "ssm_dt"):
        g[2] = dims.ssm_heads
    elif tag == "logits":
        g[2] = dims.vocab
    return tuple(g)


def make_constrain(grid: Grid, seq_sharded: bool = False,
                   share: Optional[ShareDims] = None) -> Callable:
    """The activation hook ``Model(constrain=...)`` takes.

    No compiler reads the layout here, so the hook returns its input. Inside
    device (0, 0)'s share (``share`` given) it checks that the activation
    has the block shape :func:`constrain_spec` gives its global shape, and
    raises where it has not. The check reads shapes only: no host sync.
    ``seq_sharded=True`` (long context, batch 1): sequence instead of
    batch."""

    def constrain(x: torch.Tensor, tag: str) -> torch.Tensor:
        if share is None:
            return x
        glob = _global_shape(x.shape, tag, share)
        spec = constrain_spec(grid, seq_sharded, glob, tag)
        if spec is None:
            return x
        want = block_shape(glob, spec, grid)
        if tuple(x.shape) != want:
            raise ValueError(f"{tag}: a share's activation {tuple(x.shape)} is not "
                             f"the block {want} of {glob} under {spec}")
        return x

    return constrain


def batch_shardings(grid: Grid, seq_sharded: bool = False) -> Callable[[str, tuple], Spec]:
    """Input-batch specs: tokens (b, s), prefix_embeds (b, p, d)."""
    ba = batch_axes(grid)

    def shard_for(_name: str, shape: tuple) -> Spec:
        b = shape[0]
        if seq_sharded or not _divisible(b, grid, ba):
            if len(shape) >= 2 and _divisible(shape[1], grid, ba):
                return _spec(None, ba, *([None] * (len(shape) - 2)))
            return ()
        return _spec(ba, *([None] * (len(shape) - 1)))

    return shard_for


def cache_shardings(grid: Grid, abstract_caches: Sequence[Mapping[str, torch.Tensor]],
                    seq_sharded: bool) -> List[Dict[str, Spec]]:
    """Decode-cache specs, one dict a layer. KV caches (b, S, KV, hd): b ->
    batch axes (or S -> batch axes for long-context b=1), KV heads ->
    model where divisible, else head_dim -> model. SSM state (b, h, n, p):
    h -> model. Conv state (b, k-1, ch): ch -> model."""
    ba = batch_axes(grid)

    def on(dim: int, axes: Axes) -> Optional[Axes]:
        return axes if _divisible(dim, grid, axes) else None

    def one(name: str, shape: Tuple[int, ...]) -> Spec:
        if name in ("k", "v") and len(shape) == 4:
            b, s, kv, hd = shape
            kv_ax = on(kv, "model")
            hd_ax = on(hd, "model") if kv_ax is None else None
            if seq_sharded or not _divisible(b, grid, ba):
                return _spec(None, on(s, ba), kv_ax, hd_ax)
            return _spec(ba, None, kv_ax, hd_ax)
        if name == "ssm" and len(shape) == 4:
            b, h, _n, _p = shape
            bspec = ba if _divisible(b, grid, ba) and not seq_sharded else None
            return _spec(bspec, on(h, "model"), None, None)
        if name == "conv" and len(shape) == 3:
            b, _k, ch = shape
            bspec = ba if _divisible(b, grid, ba) and not seq_sharded else None
            return _spec(bspec, None, on(ch, "model"))
        return (None,) * len(shape)                  # the length counters

    return [{k: one(k, tuple(t.shape)) for k, t in layer.items()} for layer in abstract_caches]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def block_shape(shape: Sequence[int], spec: Spec, grid: Grid) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec`` (``()``:
    the whole tensor)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, spec):
        n = axes_size(grid, axes)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def device_block(t: torch.Tensor, spec: Spec, grid: Grid,
                 coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``t`` that the device at ``coords`` (axis name -> index,
    e.g. ``{"data": i, "model": j}``) holds under ``spec``: a view."""
    sizes = axis_sizes(grid)
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    block = block_shape(t.shape, spec, grid)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        index = 0
        for a in _names(axes):                      # row-major over the names
            index = index * sizes[a] + coords.get(a, 0)
        t = t.narrow(dim, index * block[dim], block[dim])
    return t
