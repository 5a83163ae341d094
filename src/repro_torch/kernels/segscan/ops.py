"""Public wrappers of the segscan kernels: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/segscan/ops.py``.  No padding is needed:
the CUDA kernels mask their ragged last tile themselves.  Each wrapper
counts its kernel's launches in ``<wrapper>.launches``, where it makes
them: one a call, and one per group of 256 tiers for a tiered sweep.
"""
from __future__ import annotations

import torch

from ...core.scan_queue import priority_queue_scan
from .ref import queue_scan_ref, stack_scan_ref, tiered_queue_scan_ref


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` itself where it already is a contiguous ``dtype`` tensor (no
    conversion, no dispatch), else a contiguous ``dtype`` copy."""
    if x.dtype == dtype and x.is_contiguous():
        return x
    return x.to(dtype).contiguous()


def queue_scan(is_enq: torch.Tensor, valid: torch.Tensor,
               first: torch.Tensor, last: torch.Tensor):
    """Position assignment for a request batch (SKUEUE Stages 1-3).

    is_enq/valid: [n] bool; first/last: 0-d int32 tensors on the same
    device, read by the kernel through pointers (no host sync).  Returns
    (pos [n] int32 with ⊥ = -1, matched [n] bool, new_first, new_last).
    A CUDA tensor goes to the CUDA kernel, which raises if it cannot be
    built or launched; a CPU tensor goes to the plain version.
    """
    if is_enq.device.type != "cuda":
        return queue_scan_ref(is_enq, valid, first, last)
    from .kernel import queue_scan_kernel
    out = queue_scan_kernel(_as(is_enq, torch.bool), _as(valid, torch.bool),
                            _as(first, torch.int32), _as(last, torch.int32))
    queue_scan.launches += 1
    return out


def stack_scan(is_push: torch.Tensor, valid: torch.Tensor,
               last: torch.Tensor, ticket: torch.Tensor):
    """Max-plus LIFO position assignment (the stack analogue, Sec. VI).

    is_push/valid: [n] bool; last/ticket: 0-d int32 on the same device.
    Returns (pos [n] int32 with ⊥ = -1, tick [n] int32, matched [n] bool,
    new_last, new_ticket), as ``stack_scan_pallas``: a push's ticket or a
    pop's bound.  Kernel on CUDA tensors, plain version on CPU ones.
    """
    if is_push.device.type != "cuda":
        return stack_scan_ref(is_push, valid, last, ticket)
    from .kernel import stack_scan_kernel
    out = stack_scan_kernel(_as(is_push, torch.bool), _as(valid, torch.bool),
                            _as(last, torch.int32), _as(ticket, torch.int32))
    stack_scan.launches += 1
    return out


def tiered_queue_scan(enq: torch.Tensor, tier: torch.Tensor,
                      firsts: torch.Tensor, lasts: torch.Tensor,
                      n_tiers: int):
    """The fused per-tier enqueue sweep (``tiered_queue_scan_pallas``).

    enq: [n] bool (the wave's valid enqueues); tier: [n] int32 (a tier
    outside [0, n_tiers) assigns no position); firsts/lasts: [n_tiers]
    int32.  Returns (pos [n] int32 with ⊥ = -1, new_lasts [n_tiers]); an
    enqueue-only sweep never moves ``firsts``.  Kernel on CUDA tensors
    (one launch per group of 256 tiers; each group reads the whole wave
    again), plain version on CPU ones.
    """
    if lasts.shape[0] != n_tiers or firsts.shape[0] != n_tiers:
        raise ValueError(f"firsts/lasts must have {n_tiers} entries")
    if enq.device.type != "cuda":
        return tiered_queue_scan_ref(enq, tier, lasts)
    from .kernel import tier_groups, tiered_queue_scan_kernel

    def launch(enq, tier, lasts):
        out = tiered_queue_scan_kernel(enq, tier, lasts)
        tiered_queue_scan.launches += 1
        return out
    return tier_groups(launch, _as(enq, torch.bool), _as(tier, torch.int32),
                       _as(lasts, torch.int32))


def make_tier_scan(n_tiers: int):
    """Bind :func:`tiered_queue_scan` to the 4-argument ``tier_scan``
    hook that :func:`~repro_torch.core.scan_queue.priority_queue_scan`
    takes."""
    def tier_scan(enq, tier, firsts, lasts):
        return tiered_queue_scan(enq, tier, firsts, lasts, n_tiers)
    return tier_scan


def priority_queue_scan_fused(is_enq: torch.Tensor, prio: torch.Tensor,
                              valid: torch.Tensor, firsts: torch.Tensor,
                              lasts: torch.Tensor, n_prios: int):
    """Strict P-tier position assignment through the tiered sweep
    (``priority_queue_scan_pallas``): the enqueues are one
    :func:`tiered_queue_scan`, the dequeues the batch-DeleteMin prefix
    arithmetic.  Returns (tier [n] int32 (-1 unmatched), pos [n] int32
    (⊥ = -1), matched [n] bool, new_firsts, new_lasts)."""
    return priority_queue_scan(is_enq, prio, valid, firsts, lasts,
                               n_prios=n_prios,
                               tier_scan=make_tier_scan(n_prios))[:5]


queue_scan.launches = 0
stack_scan.launches = 0
tiered_queue_scan.launches = 0
