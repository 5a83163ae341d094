"""Public wrapper of the relaxed tier resolution: kernel on CUDA, plain on
CPU.

The port's own kernel: the reference resolves relaxed dequeues with a
``lax.scan`` inside the wave (``repro/core/scan_queue.py:294-316``).
"""
from __future__ import annotations

import torch

from .ref import relaxed_deletemin_ref


def relaxed_deletemin(deq: torch.Tensor, shard_of: torch.Tensor,
                      avail: torch.Tensor, firsts: torch.Tensor,
                      n_prios: int, relaxation: int, n_shards: int):
    """Resolve a wave's dequeues over P tiers with relaxation ``k``.

    deq: [n] bool (wave order); shard_of: [n] int32, each op's shard;
    avail/firsts: [P] int32, tier sizes after the wave's enqueues and the
    heads.  Returns (tier [n] int32 (-1 for ⊥ and non-dequeues), pos [n]
    int32 (⊥ = -1), matched [n] bool, taken [P] int32, n_relaxed 0-d
    int32), all on ``deq``'s device; nothing is read on the host.  A CUDA
    tensor goes to the kernel (one launch, which raises if it cannot be
    built or launched); a CPU tensor to the plain version.
    ``relaxed_deletemin.launches`` counts the kernel's launches.
    """
    if deq.device.type != "cuda":
        return relaxed_deletemin_ref(deq, shard_of, avail, firsts, n_prios,
                                     relaxation, n_shards)
    from .kernel import relaxed_deletemin_kernel
    out = relaxed_deletemin_kernel(
        deq.to(torch.bool).contiguous(),
        shard_of.to(torch.int32).contiguous(),
        avail.to(torch.int32).contiguous(),
        firsts.to(torch.int32).contiguous(), n_prios, relaxation, n_shards)
    if deq.shape[0]:
        relaxed_deletemin.launches += 1
    return out


relaxed_deletemin.launches = 0
