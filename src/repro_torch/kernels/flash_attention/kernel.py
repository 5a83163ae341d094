"""Launcher of the CUDA flash attention, ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``
and the GQA fold of its wrapper.  The CUDA source says what bounds it;
this module checks the tensors and passes pointers and strides.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..backend import check_launch, load, stream_ptr

HEAD_DIMS = (32, 64, 128)   # template instances in flash_attention.cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 9 + [_P, _P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """One launch on the current stream; no host sync.

    q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; one dtype (bf16 or f32), one
    CUDA device, any strides with the head dim contiguous.  Returns
    [B, Hq, Lq, D] in q's dtype, a view of a ``[B, Lq, Hq, D]`` buffer (the
    model's layout, so merging the heads afterwards is free).
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
    o = torch.empty(B, Lq, Hq, D, dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    err = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Hq, Hkv, Lq, Lk, D, int(causal),
        int(window or 0), ctypes.cast(strides, _P), stream_ptr(q))
    check_launch(err, "flash_attention_kernel")
    return o
