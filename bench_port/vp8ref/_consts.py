"""Device copies of the reference's constant tables, made once per device."""

from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_constants = {}


def device_constant(name: str, values, device):
    """A read-only int32 copy of the host table `values` on `device`, made once."""
    key = (name, str(device))
    with _lock:
        t = _constants.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(values, np.int32).reshape(-1)).to(device)
            _constants[key] = t
    return t


def upload(a, device):
    """The host numpy array `a` as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
