"""Launchers of the CUDA flash attention, ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (backward).

The forward replaces
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel`` and the
GQA fold of its wrapper; the backward has no Pallas counterpart (the
reference differentiates its jnp attention).  The CUDA sources say what
bounds them; this module checks the tensors, picks one of the two forward
kernels by :func:`tc_route` and one of the two backward routes by
:func:`bwd_tc_route`, and passes pointers and strides.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..backend import check_launch, load, stream_ptr

HEAD_DIMS = (32, 64, 128)   # template instances in flash_attention.cu
TC_HEAD_DIMS = (64, 128)    # flash_fwd_wgmma's instances
TC_MIN_LQ = 64              # one TMA box of queries

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 9 + [_P, _P]
        fn.restype = ctypes.c_int
        tc = lib.repro_flash_attention_tc
        tc.argtypes = [_P] * 5 + [_I] * 8 + [_P, _P]
        tc.restype = ctypes.c_int
    return lib


def tc_route(dtype: torch.dtype, D: int, Lq: int) -> bool:
    """The route rule: True sends a call to the tensor-core kernel
    (``flash_fwd_wgmma``: bf16, D 64 or 128, at least 64 queries), False
    to the scalar f32 kernel (``flash_fwd``: f32, D 32, fewer queries)."""
    return dtype == torch.bfloat16 and D in TC_HEAD_DIMS and Lq >= TC_MIN_LQ


def bwd_tc_route(dtype: torch.dtype, D: int, Lq: int, Lk: int) -> bool:
    """The backward's route rule: True sends a call to the tensor-core
    kernels (``flash_bwd_dkdv_wgmma``, ``flash_bwd_dq_wgmma``: bf16, D 64
    or 128, at least 64 queries and 64 keys), False to the ``mma.sync``
    and scalar f32 kernels (``flash_bwd_dkdv``, ``flash_bwd_dq``: f32,
    D 32, fewer rows)."""
    return (dtype == torch.bfloat16 and D in TC_HEAD_DIMS
            and min(Lq, Lk) >= TC_MIN_LQ)


def _check_tma(t: torch.Tensor, name: str) -> None:
    """TMA reads from a 16-byte-aligned base with byte strides that are
    multiples of 16 (dims of size 1 aside)."""
    bad = [s for n, s in zip(t.shape[:3], t.stride()[:3])
           if n > 1 and (s * t.element_size()) % 16]
    if t.data_ptr() % 16 or bad:
        raise ValueError(f"flash_attention_kernel: {name} needs a 16-byte "
                         f"aligned base and (batch, head, position) byte "
                         f"strides that are multiples of 16 for TMA; got "
                         f"strides {t.stride()} at {t.data_ptr():#x}")


def _check(q, k, v, window, what: str) -> None:
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{what}: q, k, v must share one dtype, bf16 or "
                         f"f32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if (k.shape != (B, Hkv, Lk, D) or v.shape != k.shape or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"(Hq % Hkv must be 0)")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the head dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: Optional[int] = None,
                           lse: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, bool]:
    """One launch on the current stream; no host sync.  ``tc_route``
    picks the kernel.

    q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; one dtype (bf16 or f32), one
    CUDA device, any strides with the head dim contiguous.  Returns
    ``(out, tensor_cores)``: out [B, Hq, Lq, D] in q's dtype, a view of a
    ``[B, Lq, Hq, D]`` buffer (the model's layout, so merging the heads
    afterwards is free), and whether the tensor-core kernel was the one
    launched.

    ``lse``: None (the prefill), or a contiguous ``[B, Hq, Lq]`` f32
    tensor that receives each row's log-sum-exp of the scaled scores
    (+inf where a row sees no key), which the backward reads.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    _check(q, k, v, window, "flash_attention_kernel")
    if lse is not None and (lse.shape != (B, Hq, Lq) or lse.dtype !=
                            torch.float32 or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError(f"flash_attention_kernel: lse must be a contiguous "
                         f"[B, Hq, Lq] float32 tensor on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lse_ptr = None if lse is None else lse.data_ptr()
    tc = tc_route(q.dtype, D, Lq)
    if tc:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            _check_tma(t, name)
    o = torch.empty(B, Lq, Hq, D, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    if tc:
        err = _lib().repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            B, Hq, Hkv, Lq, Lk, D, int(causal), int(window or 0),
            ctypes.cast(strides, _P), stream_ptr(q))
        check_launch(err, "flash_attention_kernel (tensor cores)")
        return o, True
    err = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
        int(q.dtype == torch.bfloat16), B, Hq, Hkv, Lq, Lk, D, int(causal),
        int(window or 0), ctypes.cast(strides, _P), stream_ptr(q))
    check_launch(err, "flash_attention_kernel")
    return o, False


def _bwd_lib():
    lib = load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 9 + [_P, _P]
        fn.restype = ctypes.c_int
        tc = lib.repro_flash_attention_bwd_tc
        tc.argtypes = [_P] * 11 + [_I] * 8 + [_P, _P]
        tc.restype = ctypes.c_int
    return lib


def flash_attention_bwd_kernel(q, k, v, o, dout, lse, causal: bool = True,
                               window: Optional[int] = None):
    """Three launches on the current stream (``dsum = rowsum(dO ∘ O)``,
    then dk/dv over key tiles, then dq over query tiles); no host sync.
    ``bwd_tc_route`` picks the kernels.

    q, o: [B, Hq, Lq, D]; k, v: [B, Hkv, Lk, D]; one dtype (bf16 or f32),
    any strides with the head dim contiguous (on the tensor-core route q,
    k, v need TMA's alignment, as the forward's); dout: shaped and typed
    like q, any strides (a dout the kernels cannot read, such as
    autograd's stride-0 broadcast, is copied); lse: the forward's
    ``[B, Hq, Lq]`` f32.  Returns ``((dq, dk, dv), tensor_cores)``: the
    gradients in q's dtype, views of ``[B, L, H, D]`` buffers (the model's
    layout), and whether the tensor-core kernels were the ones launched.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    _check(q, k, v, window, "flash_attention_bwd_kernel")
    tc = bwd_tc_route(q.dtype, D, Lq, Lk)
    if dout.stride(-1) != 1 or (tc and (dout.data_ptr() % 16 or any(
            n > 1 and (s <= 0 or (s * dout.element_size()) % 16)
            for n, s in zip(dout.shape[:3], dout.stride()[:3])))):
        dout = dout.contiguous()
    for t, name in ((o, "o"), (dout, "dout")):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd_kernel: {name} must be "
                             f"shaped and typed like q with the head dim "
                             f"contiguous, got {tuple(t.shape)} {t.dtype} "
                             f"strides {t.stride()}")
    if (lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd_kernel: lse must be the "
                         "forward's contiguous [B, Hq, Lq] float32")
    if tc:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            _check_tma(t, name)

    def grad_like(t):
        return torch.empty(t.shape[0], t.shape[2], t.shape[1], D,
                           dtype=q.dtype, device=q.device).transpose(1, 2)
    dq, dk, dv = grad_like(q), grad_like(k), grad_like(v)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, dout, dq, dk,
                                                  dv)
                                      for s in t.stride()[:3]))
    if tc:
        # lse·log2(e) and dsum in rows padded to 64 queries: whole TMA tiles
        lqp = -(-Lq // TC_MIN_LQ) * TC_MIN_LQ
        lse2 = torch.empty(B, Hq, lqp, dtype=torch.float32, device=q.device)
        dsum = torch.empty_like(lse2)
        err = _bwd_lib().repro_flash_attention_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), lse2.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
            Hq, Hkv, Lq, Lk, D, int(causal), int(window or 0),
            ctypes.cast(strides, _P), stream_ptr(q))
        check_launch(err, "flash_attention_bwd_kernel (tensor cores)")
        return (dq, dk, dv), True
    dsum = torch.empty(B, Hq, Lq, dtype=torch.float32, device=q.device)
    err = _bwd_lib().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16), B, Hq,
        Hkv, Lq, Lk, D, int(causal), int(window or 0),
        ctypes.cast(strides, _P), stream_ptr(q))
    check_launch(err, "flash_attention_bwd_kernel")
    return (dq, dk, dv), False
