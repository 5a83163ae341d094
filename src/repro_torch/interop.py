"""Carry a structure's state between the JAX reference and this port.

The state is the structure's data, so this is what carries "weights"
across.  :func:`state_from_jax` takes the reference's ``_state_dict()``
layout as numpy arrays and :func:`state_to_numpy` gives it back.  The
layout is told by its keys:

* queue (``ElasticDeviceQueue``): ``first``, ``last`` int32 scalars,
  ``store_vals [n, cap+1, W]`` int32, ``store_full [n, cap+1]`` bool;
* stack (``ElasticDeviceStack``): ``last``, ``ticket`` int32 scalars,
  ``vals [n, cap+1, D, W]`` int32, ``ticks [n, cap+1, D]`` int32;
* priority queue (``ElasticDevicePriorityQueue``): ``firsts``, ``lasts``
  ``[P]`` int32, ``store_vals [n, P*cap+1, W]`` int32, ``store_full [n,
  P*cap+1]`` bool.
"""
from __future__ import annotations

import numpy as np
import torch

from .dqueue.device_queue import DeviceQueueState, DeviceStackState
from .dqueue.priority_queue import PriorityQueueState

# state type -> (dtype of each field, in field order)
_LAYOUTS = {
    DeviceQueueState: (np.int32, np.int32, np.int32, bool),
    DeviceStackState: (np.int32, np.int32, np.int32, np.int32),
    PriorityQueueState: (np.int32, np.int32, np.int32, bool),
}


def _layout_of(d: dict):
    for cls in _LAYOUTS:
        if all(k in d for k in cls._fields):
            return cls
    raise KeyError(f"state dict keys {sorted(d)} match no layout: "
                   + "; ".join(str(c._fields) for c in _LAYOUTS))


def state_from_jax(d: dict, device):
    """The port's state (:class:`DeviceQueueState`,
    :class:`DeviceStackState` or :class:`PriorityQueueState`) on
    ``device`` from the reference's state dict of numpy arrays (or
    anything ``np.asarray`` takes)."""
    cls = _layout_of(d)
    # np.array copies into C order and keeps 0-d scalars 0-d
    arrs = [np.array(d[k], dtype=dt) for k, dt in zip(cls._fields,
                                                      _LAYOUTS[cls])]
    a, b, X, Y = arrs
    if (a.shape != b.shape or X.ndim != Y.ndim + 1
            or X.shape[:Y.ndim] != Y.shape):
        raise ValueError(f"{cls.__name__}: shapes {[x.shape for x in arrs]} "
                         f"do not fit {cls._fields}")
    return cls(*(torch.from_numpy(x).to(device) for x in arrs))


def state_to_numpy(state) -> dict:
    """The reference's state-dict layout as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
