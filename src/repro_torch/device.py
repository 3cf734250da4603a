"""Device selection and explicit host syncs for the port.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise: the port never drops to the CPU quietly. Callers that
want the CPU (the tests) say so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from . import obs

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_get(x: torch.Tensor, site: str = "read",
               op: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> np.ndarray:
    """Copy a tensor, or ``op(x)`` where an ``op`` is given, to a host
    numpy array: an explicit, blocking sync. ``op`` takes the syncs that
    come before the copy (``torch.nonzero`` reads its result's size) into
    the read. With recording on (:mod:`repro_torch.obs`) the read is the
    span ``sync.<site>``."""
    t0 = obs.on and obs.now()
    if op is not None:
        x = op(x)
    out = x.detach().cpu().numpy()
    if t0:
        obs.add("sync." + site, t0)
    return out


def device_put(x, device: DeviceLike, site: str = "put",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy a host array to ``device`` as a tensor (of ``dtype`` where one
    is given): a blocking copy, which waits for the device's queue to
    drain. With recording on (:mod:`repro_torch.obs`) the copy is the span
    ``sync.<site>``."""
    t0 = obs.on and obs.now()
    out = torch.as_tensor(np.asarray(x), dtype=dtype).to(device)
    if t0:
        obs.add("sync." + site, t0)
    return out
