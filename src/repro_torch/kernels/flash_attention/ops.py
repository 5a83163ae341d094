"""Public wrapper of flash attention: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/flash_attention/ops.py:flash_attention``.
The GQA fold and its per-group launches are gone: the kernel reads kv
head ``h // (Hq // Hkv)`` itself.  Where a gradient is asked for, the
call goes through :class:`FlashAttention`, a ``torch.autograd.Function``
whose backward is the hand-written backward kernel on CUDA (the plain
chunked backward on CPU); the forward then also keeps each row's
log-sum-exp for the backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import attention_backward_chunked, attention_chunked


def _forward(q, k, v, causal, window, lse=None):
    if q.device.type != "cuda":
        flash_attention.plain_calls += 1
        return attention_chunked(q, k, v, causal=causal, window=window)
    from .kernel import flash_attention_kernel
    out, tensor_cores = flash_attention_kernel(q, k, v, causal=causal,
                                               window=window, lse=lse)
    flash_attention.launches += 1
    flash_attention.tc_launches += tensor_cores
    return out


class FlashAttention(torch.autograd.Function):
    """Attention with a hand-written backward.  On CUDA: the forward kernel
    (either route) writing the rows' log-sum-exp, and the backward kernels
    (``csrc/flash_attention_bwd.cu``: dsum, then dk/dv, then dq, on the
    wgmma route or the mma.sync/f32 one by ``kernel.bwd_tc_route``; no
    float atomics).  On CPU: :func:`attention_chunked` and
    :func:`attention_backward_chunked`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        lse = None
        if q.device.type == "cuda":
            B, Hq, Lq, _ = q.shape
            lse = torch.empty(B, Hq, Lq, dtype=torch.float32,
                              device=q.device)
        out = _forward(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type != "cuda":
            flash_attention.plain_calls += 1
            grads = attention_backward_chunked(q, k, v, out, dout,
                                               causal=ctx.causal,
                                               window=ctx.window)
        else:
            from .kernel import flash_attention_bwd_kernel
            grads, tensor_cores = flash_attention_bwd_kernel(
                q, k, v, out, dout, lse, causal=ctx.causal,
                window=ctx.window)
            flash_attention.bwd_launches += 1
            flash_attention.bwd_tc_launches += tensor_cores
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; Hq % Hkv == 0 (GQA).

    Returns [B, Hq, Lq, D] in q's dtype.  Any Lq and Lk are taken (no
    block multiple).  Queries align to the end of the keys (query i sits
    at position Lk - Lq + i) for the masks: ``causal`` keeps keys at or
    before it, ``window`` the last ``window`` of those.  With
    ``causal=False`` and no window nothing is masked and Lq and Lk are
    free of each other (the encoder's self-attention, cross-attention,
    Lq > Lk); a causal Lq > Lk leaves the first Lq - Lk queries with no
    key, and their rows are 0.  A CUDA tensor goes
    to a CUDA kernel, which raises if it cannot be built or launched; a
    CPU tensor goes to the plain version.  When grad mode is on and an
    input requires a gradient, the call is differentiable through
    :class:`FlashAttention`; otherwise it is the one forward launch (no
    log-sum-exp written).  Counters: ``flash_attention.launches`` counts
    launches of either forward kernel, ``flash_attention.tc_launches``
    those of the tensor-core one, as the launcher reports them;
    ``flash_attention.bwd_launches`` backward calls that went to the
    backward kernels (three launches each),
    ``flash_attention.bwd_tc_launches`` those on the tensor-core route
    (``flash_bwd_dkdv_wgmma``, ``flash_bwd_dq_wgmma``), as the launcher
    reports them;
    ``flash_attention.plain_calls`` forward or backward calls that ran a
    plain version (CPU tensors).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_tc_launches = 0
flash_attention.plain_calls = 0
