"""Public wrapper of the SSD scan: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/ssd_scan/ops.py:ssd_scan_pallas``.  No
padding: the CUDA kernel masks a ragged last chunk itself.
"""
from __future__ import annotations

import torch

from .ref import ssd_chunked_ref


def ssd_scan(xt: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> torch.Tensor:
    """Chunked SSD scan, y_t = C_t S_t with S_t = exp(loga_t) S_{t-1} +
    B_t ⊗ xt_t.

    Shapes: the model's ``xt [b, H, L, P]``, ``loga [b, H, L]``,
    ``B/C [b, H, L, N]``, where B/C may be a stride-0 expand along H.
    xt and loga are float32, B/C bfloat16 or float32; the result is
    float32, shaped like xt.  A CUDA tensor goes to the CUDA kernel, which
    raises if it cannot be built or launched; a CPU tensor goes to the
    plain version.  ``ssd_scan.launches`` counts calls that went to the
    kernel; each call issues three launches (chunk states, state passing,
    outputs).
    """
    if xt.device.type != "cuda":
        return ssd_chunked_ref(xt, loga, B, C)
    from .kernel import ssd_scan_kernel
    y = ssd_scan_kernel(xt, loga, B, C)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
