"""Launcher of the CUDA hash route, ``csrc/hash_route.cu``.

Replaces ``repro/kernels/hash_route/kernel.py:hash_route_kernel``.  The
CUDA source says what bounds it; this module checks the tensors and
passes pointers.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, stream_ptr

MAX_SHARDS = 12 * 1024   # the shared-memory histogram stays under 48 KB
BLOCKS_PER_SM = 8

_P = ctypes.c_void_p


def _lib():
    lib = load("hash_route")
    fn = lib.repro_hash_route
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return lib


def hash_route_kernel(pos: torch.Tensor, valid: torch.Tensor,
                      n_shards: int):
    """One launch on the current stream (plus the zeroing of the counts).

    pos: [n] int32, valid: [n] bool, contiguous, on one CUDA device.
    Returns (owner [n] int32, counts [n_shards] int32) on the device.
    """
    dev = pos.device
    n = pos.shape[0]
    if pos.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("hash_route_kernel: pos must be int32 and valid "
                         f"bool, got {pos.dtype} and {valid.dtype}")
    if (valid.device != dev or pos.dim() != 1 or valid.shape != (n,)
            or not (pos.is_contiguous() and valid.is_contiguous())):
        raise ValueError("hash_route_kernel: pos/valid must be contiguous "
                         "[n] tensors on one device")
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"hash_route_kernel: n_shards must be in "
                         f"[1, {MAX_SHARDS}], got {n_shards}")
    owner = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_shards, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _lib().repro_hash_route(
        pos.data_ptr(), valid.data_ptr(), owner.data_ptr(),
        counts.data_ptr(), n, n_shards, BLOCKS_PER_SM * sms, stream_ptr(pos))
    check_launch(err, "hash_route_kernel")
    return owner, counts
