"""Device selection and explicit host syncs for the port.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise: the port never drops to the CPU quietly. Callers that
want the CPU (the tests) say so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

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


def device_get(x: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host numpy array (an explicit, blocking sync)."""
    return x.detach().cpu().numpy()
