"""Launcher of the CUDA SSD scan, ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel``.  The CUDA
source says what bounds it; this module checks the tensors, allocates the
scratch (each chunk's state, each chunk's decay) and passes pointers and
strides.  One call issues three kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, stream_ptr

MAX_SMEM = 232_448   # bytes of shared memory one block may use on Hopper
CHUNK = 64           # tokens per chunk, fixed in ssd_scan.cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_P, _P]
        fn.restype = ctypes.c_int
        lib.repro_ssd_scan_smem.argtypes = [_I] * 3
        lib.repro_ssd_scan_smem.restype = ctypes.c_int64
    return lib


def _bhl(name: str, t: torch.Tensor):
    """(batch, head, position) element strides of a 4-D tensor whose last
    dim must be contiguous."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"ssd_scan_kernel: {name}'s last dim must be "
                         f"contiguous, strides {t.stride()}")
    return list(t.stride()[:3])


def ssd_scan_kernel(xt: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> torch.Tensor:
    """Three launches on the current stream; no host sync.

    xt: [b, H, L, P] f32; loga: [b, H, L] f32; B/C: [b, H, L, N], bf16 or
    f32, any strides with the last dim contiguous (a stride-0 expand along
    H is read as it is, and B and C are then loaded once for a group of
    heads).  P and N multiples of 16.  Returns y [b, H, L, P] f32, a view
    of a ``[b, L, H, P]`` buffer (the model's layout).  Scratch:
    ``b·H·ceil(L/CHUNK)·N·P`` f32 of chunk states.
    """
    b, H, L, P = xt.shape
    N = B.shape[-1]
    dev = xt.device
    if xt.dtype != torch.float32 or loga.dtype != torch.float32:
        raise ValueError(f"ssd_scan_kernel: xt and loga must be float32, got "
                         f"{xt.dtype} and {loga.dtype}")
    if B.dtype != C.dtype or B.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ssd_scan_kernel: B and C must both be bfloat16 or "
                         f"float32, got {B.dtype} and {C.dtype}")
    if (loga.shape != (b, H, L) or B.shape != (b, H, L, N)
            or C.shape != B.shape):
        raise ValueError(f"ssd_scan_kernel: shapes xt {tuple(xt.shape)}, "
                         f"loga {tuple(loga.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} do not fit")
    if any(t.device != dev for t in (loga, B, C)):
        raise ValueError("ssd_scan_kernel: all inputs must be on one device")
    if P < 16 or N < 16 or P % 16 or N % 16:
        raise ValueError(f"ssd_scan_kernel: P={P} and N={N} must be "
                         f"multiples of 16")
    bc_bf16 = int(B.dtype == torch.bfloat16)
    lib = _lib()
    smem = lib.repro_ssd_scan_smem(P, N, bc_bf16)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan_kernel: P={P}, N={N} "
                         f"need {smem} bytes of shared memory, over the "
                         f"{MAX_SMEM} a block has")
    nc = -(-L // CHUNK)
    y = torch.empty(b, L, H, P, dtype=torch.float32,
                    device=dev).transpose(1, 2)
    states = torch.empty(b, H, nc, N, P, dtype=torch.float32, device=dev)
    decay = torch.empty(b, H, nc, dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 15)(
        *_bhl("xt", xt), *loga.stride(), *_bhl("B", B), *_bhl("C", C),
        *_bhl("y", y))
    err = lib.repro_ssd_scan(
        xt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), decay.data_ptr(), bc_bf16, b, H,
        L, P, N, ctypes.cast(strides, _P), stream_ptr(xt))
    check_launch(err, "ssd_scan_kernel")
    return y
