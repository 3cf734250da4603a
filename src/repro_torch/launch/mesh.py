"""Device grids — the counterpart of ``repro.launch.mesh``.

The port passes grids explicitly: a grid is a list of rows of
``torch.device`` (the ``(data, model)`` axes), one process drives every
device of it, and nothing here touches a device at import. The reference's
``mesh_context`` (a ``jax.set_mesh`` scope) has no counterpart, because no
operation here reads an ambient grid.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device


def make_production_grid(*, multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production grid's shape and axis names, the reference's:
    ``(16, 16)`` over ``("data", "model")``, and with ``multi_pod`` a
    leading ``"pod"`` axis, ``(2, 16, 16)``. So every per-device block
    shape the dry run prices equals the reference's. Touches no device.

    On NVIDIA hardware 16 model peers span two 8-GPU HGX H100 nodes, so
    the model axis's per-round fold crosses the nodes' network as well as
    NVLink; choosing another grid shape for the card is a later decision
    than this one."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_host_grid(model_axis: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None
                   ) -> List[List[torch.device]]:
    """The ``(data, model)`` grid over the devices at hand (reference
    ``make_host_mesh``): ``devices`` (None: every visible CUDA card; raises
    without one; repeats allowed, ``["cuda:0"] * 4`` gives four shards on
    one card), the model axis clamped to the device count, ``data =
    len(devices) // model``, row-major. A one-device list gives the 1x1
    grid."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_canonical(resolve_device(d)) for d in devices]
    if not devs:
        raise ValueError("the mesh needs at least one device")
    model = max(1, min(int(model_axis), len(devs)))
    data = max(len(devs) // model, 1)
    return [devs[i * model:(i + 1) * model] for i in range(data)]
