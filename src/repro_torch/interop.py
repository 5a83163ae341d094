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
  P*cap+1]`` bool;
* Seap queue (``ElasticDeviceSeapQueue``): the priority queue's keys with
  ``B`` buckets for ``P`` tiers, plus the directory: ``lo [B]`` int32,
  ``active [B]`` bool, ``key_lo``, ``key_hi`` int32 scalars.

A Seap state dict holds every key of a priority one, so the layout with
the most fields whose keys are all present is taken.

A model's parameters are carried by :func:`params_from_jax` and
:func:`params_to_numpy`, bit for bit, bfloat16 included.
"""
from __future__ import annotations

import numpy as np
import torch

from .dqueue.device_queue import DeviceQueueState, DeviceStackState
from .dqueue.priority_queue import PriorityQueueState
from .dqueue.seap_queue import SeapQueueState

# state type -> (dtype of each field, in field order); the interval pair
# comes first and the store pair last in every layout
_LAYOUTS = {
    DeviceQueueState: (np.int32, np.int32, np.int32, bool),
    DeviceStackState: (np.int32, np.int32, np.int32, np.int32),
    PriorityQueueState: (np.int32, np.int32, np.int32, bool),
    SeapQueueState: (np.int32, np.int32, np.int32, bool, np.int32, np.int32,
                     np.int32, bool),
}


def _layout_of(d: dict):
    """The layout with the most fields whose keys ``d`` all holds (a Seap
    dict holds a priority dict's keys too)."""
    fits = [cls for cls in _LAYOUTS if all(k in d for k in cls._fields)]
    if not fits:
        raise KeyError(f"state dict keys {sorted(d)} match no layout: "
                       + "; ".join(str(c._fields) for c in _LAYOUTS))
    return max(fits, key=lambda cls: len(cls._fields))


def state_from_jax(d: dict, device):
    """The port's state (:class:`DeviceQueueState`,
    :class:`DeviceStackState`, :class:`PriorityQueueState` or
    :class:`SeapQueueState`) on ``device`` from the reference's state dict
    of numpy arrays (or anything ``np.asarray`` takes)."""
    cls = _layout_of(d)
    # np.array copies into C order and keeps 0-d scalars 0-d
    arrs = [np.array(d[k], dtype=dt) for k, dt in zip(cls._fields,
                                                      _LAYOUTS[cls])]
    a, b, X, Y = arrs[0], arrs[1], arrs[-2], arrs[-1]
    ok = (a.shape == b.shape and X.ndim == Y.ndim + 1
          and X.shape[:Y.ndim] == Y.shape)
    if cls is SeapQueueState:     # the directory: [B] vectors, 0-d range
        lo, active, key_lo, key_hi = arrs[2:6]
        ok = (ok and a.ndim == 1 and lo.shape == active.shape == a.shape
              and key_lo.ndim == key_hi.ndim == 0)
    if not ok:
        raise ValueError(f"{cls.__name__}: shapes {[x.shape for x in arrs]} "
                         f"do not fit {cls._fields}")
    return cls(*(torch.from_numpy(x).to(device) for x in arrs))


def state_to_numpy(state) -> dict:
    """The reference's state-dict layout as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    """One array as a tensor on ``device``, bit for bit.  ``np.asarray``
    of a JAX bfloat16 array is an ``ml_dtypes.bfloat16`` array, which
    ``torch.from_numpy`` rejects: it crosses as its 16-bit patterns
    (uint16 -> int16 -> ``torch.bfloat16``), which is exact."""
    a = np.array(a, order="C")        # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device):
    """The port's parameters on ``device`` from the reference's parameter
    pytree (nested dicts of arrays, the stacked ``layers`` axis kept), bit
    for bit.  A bare array is a tree of one leaf."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _leaf_from_numpy(tree, device)


def params_to_numpy(tree):
    """The same tree as numpy arrays; bfloat16 leaves come back as their
    uint16 bit patterns (numpy has no bfloat16 of its own)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
