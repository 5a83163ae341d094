"""Public wrapper of the hash route: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/hash_route/ops.py:hash_route_pallas``.
"""
from __future__ import annotations

import torch

from .ref import hash_route_ref


def hash_route(pos: torch.Tensor, valid: torch.Tensor, n_shards: int):
    """Owner shard and per-shard counts for a batch of DHT positions.

    pos: [n] int32; valid: [n] bool.  Returns (owner [n] int32 with -1
    for invalid, counts [n_shards] int32).  A CUDA tensor goes to the CUDA
    kernel, which raises if it cannot be built or launched; a CPU tensor
    goes to the plain version.  ``hash_route.launches`` counts launches.
    """
    if pos.device.type != "cuda":
        return hash_route_ref(pos, valid, n_shards)
    if pos.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=pos.device),
                torch.zeros(n_shards, dtype=torch.int32, device=pos.device))
    from .kernel import hash_route_kernel
    out = hash_route_kernel(pos.to(torch.int32).contiguous(),
                            valid.to(torch.bool).contiguous(), n_shards)
    hash_route.launches += 1
    return out


hash_route.launches = 0
