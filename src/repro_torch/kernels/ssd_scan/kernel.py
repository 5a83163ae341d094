"""Launchers of the CUDA SSD scan, ``csrc/ssd_scan.cu``, and of its
backward, ``csrc/ssd_scan_bwd.cu``.

The forward replaces ``repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel``;
the backward has no Pallas counterpart (the reference differentiates its
jnp chunked scan).  The CUDA sources say what bounds them; this module
checks the tensors, allocates the scratch (each chunk's states, decays,
the backward's partial sums) and passes pointers and strides.  A forward
call issues three kernel launches, a backward call three.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, stream_ptr

MAX_SMEM = 232_448   # bytes of shared memory one block may use on Hopper
CHUNK = 64           # tokens per chunk, fixed in ssd_scan.cu

_P = ctypes.c_void_p
_I = ctypes.c_int


BWD_N = (16, 32, 64, 128)   # the backward's template instances
BWD_MAX_P = 128
HEAD_GROUP = 8              # heads a block of the backward's chunk pass
                            # takes (ssd_scan_bwd.cu: kHeadGroup)


def _lib():
    lib = load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 6 + [_P, _P]
        fn.restype = ctypes.c_int
        lib.repro_ssd_scan_smem.argtypes = [_I] * 3
        lib.repro_ssd_scan_smem.restype = ctypes.c_int64
    return lib


def _bwd_lib():
    lib = load("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 8 + [_P, _P]
        fn.restype = ctypes.c_int
        lib.repro_ssd_scan_bwd_smem.argtypes = [_I] * 3
        lib.repro_ssd_scan_bwd_smem.restype = ctypes.c_int64
    return lib


def _bhl(name: str, t: torch.Tensor, what: str = "ssd_scan_kernel"):
    """(batch, head, position) element strides of a 4-D tensor whose last
    dim must be contiguous."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{what}: {name}'s last dim must be "
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


def ssd_scan_bwd_kernel(xt: torch.Tensor, loga: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, y: torch.Tensor,
                        dy: torch.Tensor):
    """Gradients ``(dxt, dloga, dB, dC)`` of ``y = ssd_scan(xt, loga, B,
    C)`` given ``dy``: three launches on the current stream (the state
    walks, the chunks, the finish); no host sync.

    xt, y, dy: [b, H, L, P] f32; loga: [b, H, L] f32; B/C: [b, 1, L, N]
    (one group shared by every head) or [b, H, L, N] (a stride-0 expand
    included), bf16 or f32; any strides with the last dim contiguous.  N
    in ``BWD_N``, P a multiple of 16 up to ``BWD_MAX_P``.  Returns dxt
    [b, H, L, P] f32 (a view of a ``[b, L, H, P]`` buffer, the model's
    layout), dloga [b, H, L] f32, and dB, dC f32 shaped like B and C: a
    one-group B or C gets the per-head gradients summed over the heads, as
    ``ref.ssd_scan_backward_ref``.  Scratch: two ``[b, H, ceil(L/64), N,
    P]`` f32 state sequences, and ``[b, ceil(H/8), L, N]`` f32 partials
    for each one-group B or C.
    """
    what = "ssd_scan_bwd_kernel"
    b, H, L, P = xt.shape
    N = B.shape[-1]
    dev = xt.device
    if any(t.dtype != torch.float32 for t in (xt, loga, y, dy)):
        raise ValueError(f"{what}: xt, loga, y and dy must be float32")
    if B.dtype != C.dtype or B.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: B and C must both be bfloat16 or "
                         f"float32, got {B.dtype} and {C.dtype}")
    if (loga.shape != (b, H, L) or y.shape != xt.shape
            or dy.shape != xt.shape
            or any(t.shape[0] != b or t.shape[1] not in (1, H)
                   or t.shape[2:] != (L, N) for t in (B, C))):
        raise ValueError(f"{what}: shapes xt {tuple(xt.shape)}, loga "
                         f"{tuple(loga.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, y {tuple(y.shape)}, dy "
                         f"{tuple(dy.shape)} do not fit")
    if any(t.device != dev for t in (loga, B, C, y, dy)):
        raise ValueError(f"{what}: all inputs must be on one device")
    if N not in BWD_N or P % 16 or not 16 <= P <= BWD_MAX_P:
        raise ValueError(f"{what}: N={N} must be one of {BWD_N} and P={P} "
                         f"a multiple of 16 up to {BWD_MAX_P}")
    bc_bf16 = int(B.dtype == torch.bfloat16)
    lib = _bwd_lib()
    smem = lib.repro_ssd_scan_bwd_smem(P, N, bc_bf16)
    if smem > MAX_SMEM:
        raise ValueError(f"{what}: P={P}, N={N} need {smem} bytes of shared "
                         f"memory, over the {MAX_SMEM} a block has")
    sum_b, sum_c = int(B.shape[1] != H), int(C.shape[1] != H)
    shape = (b, H, L, N)
    Bh, Ch = B.expand(shape), C.expand(shape)
    nc, ng = -(-L // CHUNK), -(-H // HEAD_GROUP)
    f32 = dict(dtype=torch.float32, device=dev)
    dxt = torch.empty(b, L, H, P, **f32).transpose(1, 2)
    dloga = torch.empty(b, H, L, **f32)
    dB = torch.empty(b, 1 if sum_b else H, L, N, **f32)
    dC = torch.empty(b, 1 if sum_c else H, L, N, **f32)
    dBp = torch.empty(b, ng, L, N, **f32) if sum_b else dB
    dCp = torch.empty(b, ng, L, N, **f32) if sum_c else dC
    states = torch.empty(b, H, nc, N, P, **f32)
    gstates = torch.empty_like(states)
    totals = torch.empty(b, H, nc, **f32)
    strides = (ctypes.c_int64 * 21)(
        *_bhl("xt", xt, what), *loga.stride(), *_bhl("B", Bh, what),
        *_bhl("C", Ch, what), *_bhl("y", y, what), *_bhl("dy", dy, what),
        *_bhl("dxt", dxt, what))
    err = lib.repro_ssd_scan_bwd(
        xt.data_ptr(), loga.data_ptr(), Bh.data_ptr(), Ch.data_ptr(),
        y.data_ptr(), dy.data_ptr(), dxt.data_ptr(), dloga.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
        states.data_ptr(), gstates.data_ptr(), totals.data_ptr(), bc_bf16,
        sum_b, sum_c, b, H, L, P, N,
        ctypes.cast(strides, _P), stream_ptr(xt))
    check_launch(err, what)
    return dxt, dloga, dB, dC
