"""Public wrapper of the FIFO segscan: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/segscan/ops.py:queue_scan_pallas``.  No
padding is needed: the CUDA kernel masks its ragged last block itself.
"""
from __future__ import annotations

import torch

from .ref import queue_scan_ref


def queue_scan(is_enq: torch.Tensor, valid: torch.Tensor,
               first: torch.Tensor, last: torch.Tensor):
    """Position assignment for a request batch (SKUEUE Stages 1-3).

    is_enq/valid: [n] bool; first/last: 0-d int32 tensors on the same
    device, read by the kernel through pointers (no host sync).  Returns
    (pos [n] int32 with ⊥ = -1, matched [n] bool, new_first, new_last).
    A CUDA tensor goes to the CUDA kernel, which raises if it cannot be
    built or launched; a CPU tensor goes to the plain version.
    ``queue_scan.launches`` counts kernel launch sequences.
    """
    if is_enq.device.type != "cuda":
        return queue_scan_ref(is_enq, valid, first, last)
    from .kernel import queue_scan_kernel
    out = queue_scan_kernel(is_enq.contiguous(), valid.contiguous(),
                            first.to(torch.int32).contiguous(),
                            last.to(torch.int32).contiguous())
    queue_scan.launches += 1
    return out


queue_scan.launches = 0
