"""Launcher of the CUDA flash attention, ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``
and the GQA fold of its wrapper.  The CUDA source says what bounds it;
this module checks the tensors, picks one of its two kernels by
:func:`tc_route`, and passes pointers and strides.
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
        fn.argtypes = [_P] * 4 + [_I] * 9 + [_P, _P]
        fn.restype = ctypes.c_int
        tc = lib.repro_flash_attention_tc
        tc.argtypes = [_P] * 4 + [_I] * 8 + [_P, _P]
        tc.restype = ctypes.c_int
    return lib


def tc_route(dtype: torch.dtype, D: int, Lq: int) -> bool:
    """The route rule: True sends a call to the tensor-core kernel
    (``flash_fwd_wgmma``: bf16, D 64 or 128, at least 64 queries), False
    to the scalar f32 kernel (``flash_fwd``: f32, D 32, fewer queries)."""
    return dtype == torch.bfloat16 and D in TC_HEAD_DIMS and Lq >= TC_MIN_LQ


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


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, bool]:
    """One launch on the current stream; no host sync.  ``tc_route``
    picks the kernel.

    q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; one dtype (bf16 or f32), one
    CUDA device, any strides with the head dim contiguous.  Returns
    ``(out, tensor_cores)``: out [B, Hq, Lq, D] in q's dtype, a view of a
    ``[B, Lq, Hq, D]`` buffer (the model's layout, so merging the heads
    afterwards is free), and whether the tensor-core kernel was the one
    launched.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_attention_kernel: q, k, v must share one "
                         f"dtype, bf16 or f32; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if (k.shape != (B, Hkv, Lk, D) or v.shape != k.shape or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"flash_attention_kernel: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"fit (Hq % Hkv must be 0)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_kernel: q, k, v on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_kernel: the head dim must be "
                         "contiguous")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_kernel: window {window} < 1")
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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Lq, Lk, D, int(causal), int(window or 0),
            ctypes.cast(strides, _P), stream_ptr(q))
        check_launch(err, "flash_attention_kernel (tensor cores)")
        return o, True
    err = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Hq, Hkv, Lq, Lk, D, int(causal),
        int(window or 0), ctypes.cast(strides, _P), stream_ptr(q))
    check_launch(err, "flash_attention_kernel")
    return o, False
