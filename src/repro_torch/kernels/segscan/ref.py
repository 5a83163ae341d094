"""Plain PyTorch version of the FIFO segscan kernel.

Counterpart of ``repro/kernels/segscan/ref.py``: it delegates to the
framework scan, :func:`repro_torch.core.scan_queue.queue_scan`.
"""
from __future__ import annotations

import torch

from ...core.scan_queue import QueueState, queue_scan


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
