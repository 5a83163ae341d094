"""Plain PyTorch versions of the segscan kernels.

Counterpart of ``repro/kernels/segscan/ref.py``.  The FIFO and LIFO scans
delegate to the framework scans in :mod:`repro_torch.core.scan_queue`;
the tiered sweep is its own short function (a stable sort by tier gives
each enqueue its rank among earlier enqueues of the same tier), since the
reference's oracle for it, one masked FIFO scan per tier, is P scans.
"""
from __future__ import annotations

import torch

from ...core.scan_queue import QueueState, StackState, queue_scan, stack_scan


def queue_scan_ref(is_enq: torch.Tensor, valid: torch.Tensor,
                   first: torch.Tensor, last: torch.Tensor):
    """Returns (positions [n] int32 with ⊥ = -1, matched [n] bool,
    new_first, new_last), the last two 0-d int32."""
    pos, matched, new = queue_scan(
        is_enq.to(torch.bool),
        QueueState(first.to(torch.int32), last.to(torch.int32)),
        valid=valid.to(torch.bool))
    return (pos, matched, new.first.to(torch.int32),
            new.last.to(torch.int32))


def stack_scan_ref(is_push: torch.Tensor, valid: torch.Tensor,
                   last: torch.Tensor, ticket: torch.Tensor):
    """Returns (positions [n] int32 with ⊥ = -1, tickets [n] int32,
    matched [n] bool, new_last, new_ticket)."""
    pos, tick, matched, new = stack_scan(
        is_push.to(torch.bool),
        StackState(last.to(torch.int32), ticket.to(torch.int32)),
        valid=valid.to(torch.bool))
    return pos, tick, matched, new.last, new.ticket


def tiered_queue_scan_ref(enq: torch.Tensor, tier: torch.Tensor,
                          lasts: torch.Tensor):
    """Per-tier enqueue positions: an enqueue of tier t in [0, P) gets
    ``lasts[t] + 1 +`` (earlier enqueues of tier t); anything else -1.
    Returns (pos [n] int32, new_lasts [P] int32)."""
    P = lasts.shape[0]
    n = enq.shape[0]
    tier = tier.to(torch.int64)
    live = enq.to(torch.bool) & (tier >= 0) & (tier < P)
    key = torch.where(live, tier, P)
    skey, order = torch.sort(key, stable=True)
    first_of_key = torch.searchsorted(skey, skey)
    rank = torch.empty_like(key).scatter_(
        0, order, torch.arange(n, device=key.device) - first_of_key)
    counts = torch.bincount(key, minlength=P + 1)[:P]
    lasts = lasts.to(torch.int64)
    pos = torch.where(live, lasts[key.clamp_max(P - 1)] + 1 + rank, -1)
    # int32 wrap-around, as the reference's int32 sums have it
    wrap = torch.remainder(pos + 2 ** 31, 2 ** 32) - 2 ** 31
    new = torch.remainder(lasts + counts + 2 ** 31, 2 ** 32) - 2 ** 31
    return wrap.to(torch.int32), new.to(torch.int32)
