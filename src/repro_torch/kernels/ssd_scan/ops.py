"""Public wrapper of the SSD scan: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/ssd_scan/ops.py:ssd_scan_pallas``.  No
padding: the CUDA kernel masks a ragged last chunk itself.  Where a
gradient is asked for, the call goes through :class:`SSDScan`, a
``torch.autograd.Function`` whose backward is the hand-written backward
kernel (``csrc/ssd_scan_bwd.cu``, three launches) on CUDA and the plain
backward (``ref.py:ssd_scan_backward_ref``) on the CPU.
"""
from __future__ import annotations

import torch

from .ref import ssd_chunked_ref, ssd_scan_backward_ref


def _forward(xt, loga, B, C):
    if xt.device.type != "cuda":
        ssd_scan.plain_calls += 1
        return ssd_chunked_ref(xt, loga, B, C)
    from .kernel import ssd_scan_kernel
    shape = xt.shape[:3] + B.shape[3:]
    y = ssd_scan_kernel(xt, loga, B.expand(shape), C.expand(shape))
    ssd_scan.launches += 1
    return y


class SSDScan(torch.autograd.Function):
    """The scan with a hand-written backward: on CUDA the forward kernel and
    the backward kernel (the forward and adjoint state walks, the chunks'
    dxt, dB, dC and dloga, the cross-chunk finish); on CPU the
    chunked plain version of each.  A B or C of one head is shared by all:
    its gradient is the per-head one summed over the heads in f32 and cast
    to its type once."""

    @staticmethod
    def forward(ctx, xt, loga, B, C):
        y = _forward(xt, loga, B, C)
        ctx.save_for_backward(xt, loga, B, C, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        xt, loga, B, C, y = ctx.saved_tensors
        if xt.device.type != "cuda":
            ssd_scan.plain_calls += 1
            return ssd_scan_backward_ref(xt, loga, B, C, y, dy)
        from .kernel import ssd_scan_bwd_kernel
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        grads = ssd_scan_bwd_kernel(xt, loga, B, C, y, dy)
        ssd_scan.bwd_calls += 1
        return grads


def ssd_scan(xt: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor) -> torch.Tensor:
    """Chunked SSD scan, y_t = C_t S_t with S_t = exp(loga_t) S_{t-1} +
    B_t ⊗ xt_t.

    Shapes: ``xt [b, H, L, P]``, ``loga [b, H, L]``, ``B/C [b, H, L, N]``
    or ``[b, 1, L, N]``, one group shared by every head (the model's form;
    the kernel reads it with stride 0 over the heads).
    xt and loga are float32, B/C bfloat16 or float32; the result is
    float32, shaped like xt.  A CUDA tensor goes to the CUDA kernel, which
    raises if it cannot be built or launched; a CPU tensor goes to the
    plain version.  When grad mode is on and an input requires a
    gradient, the call is differentiable through :class:`SSDScan`.
    Counters: ``ssd_scan.launches`` counts forward calls that went to the
    kernel (three launches each: chunk states, state passing, outputs);
    ``ssd_scan.bwd_calls`` backward calls on CUDA (three launches of the
    backward kernel each); ``ssd_scan.plain_calls`` forward or backward
    calls that ran the plain version (CPU tensors).
    """
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xt, loga, B, C)):
        return SSDScan.apply(xt, loga, B, C)
    return _forward(xt, loga, B, C)


ssd_scan.launches = 0
ssd_scan.bwd_calls = 0
ssd_scan.plain_calls = 0
