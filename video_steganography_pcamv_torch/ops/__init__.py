"""Tensor primitives (plain PyTorch) and the kernel wrappers."""

import numpy as np
import torch

_CONST: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """Device copy of a module-level numpy table, cached per device
    (the tables are immutable module constants, so `id` is stable)."""
    dev = torch.device(device)
    key = (id(arr), str(dev))
    t = _CONST.get(key)
    if t is None:
        t = _CONST[key] = torch.as_tensor(arr, device=dev)
    return t
