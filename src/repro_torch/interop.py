"""Carry a queue's state between the JAX reference and this port.

The queue's state is its data, so this is what carries "weights" across:
:func:`state_from_jax` takes the reference's
``ElasticDeviceQueue._state_dict()`` layout as numpy arrays (``first``,
``last`` int32 scalars, ``store_vals [n, cap+1, W]`` int32,
``store_full [n, cap+1]`` bool) and :func:`state_to_numpy` gives it back.
"""
from __future__ import annotations

import numpy as np
import torch

from .dqueue.device_queue import DeviceQueueState

STATE_KEYS = ("first", "last", "store_vals", "store_full")


def state_from_jax(d: dict, device) -> DeviceQueueState:
    """A :class:`DeviceQueueState` on ``device`` from the reference's
    state dict of numpy arrays (or anything ``np.asarray`` takes)."""
    missing = [k for k in STATE_KEYS if k not in d]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    sv = np.ascontiguousarray(np.asarray(d["store_vals"], np.int32))
    sf = np.ascontiguousarray(np.asarray(d["store_full"], bool))
    if sv.ndim != 3 or sf.shape != sv.shape[:2]:
        raise ValueError(f"store shapes {sv.shape} / {sf.shape} are not "
                         f"[n, cap+1, W] / [n, cap+1]")

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=device)

    return DeviceQueueState(scalar(d["first"]), scalar(d["last"]),
                            torch.from_numpy(sv).to(device),
                            torch.from_numpy(sf).to(device))


def state_to_numpy(state: DeviceQueueState) -> dict:
    """The reference's state-dict layout as numpy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_KEYS}
