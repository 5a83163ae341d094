"""Plain PyTorch version of the hash-route kernel.

Counterpart of ``repro/kernels/hash_route/ref.py``: a position's owner
under the paper's consistent hashing (Sec. II-B) with equal-width shard
intervals, from a 32-bit splitmix finalizer.  PyTorch's CPU ``uint32`` has
no ``>>`` or ``%``, so the hash runs in int64 holding the low 32 bits.
The second multiplier is >= 2^31, so a 32x32-bit product can pass 2^63;
:func:`_mul32` multiplies in 16-bit halves to keep exactly the low 32 bits.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant m."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer of int32 ``x`` read as uint32; int64 result."""
    x = x.to(torch.int64) & _MASK
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_route_ref(pos: torch.Tensor, valid: torch.Tensor, n_shards: int):
    """Returns (owner [n] int32 with -1 for invalid, counts [n_shards]
    int32)."""
    owner = torch.remainder(_mix32(pos) >> 8, n_shards)
    owner = torch.where(valid, owner, -1).to(torch.int32)
    counts = torch.bincount(owner[valid].to(torch.int64),
                            minlength=n_shards)[:n_shards]
    return owner, counts.to(torch.int32)
