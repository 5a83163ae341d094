"""Launcher of the CUDA hash route, ``csrc/hash_route.cu``.

Replaces ``repro/kernels/hash_route/kernel.py:hash_route_kernel``.  The
CUDA source says what bounds it; this module checks the tensors, sizes the
grid and passes pointers.  One launch a call, its outputs from
``torch.empty``: the grid is one thread-block cluster whose block 0 sums
the blocks' histograms, so nothing is kept between calls and a call can be
captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, raw_stream

MAX_SHARDS = 12 * 1024   # the shared-memory histogram: 48 KB, the default
THREADS = 1024           # hash_route.cu's kThreads
VEC = 4                  # elements a thread a group; hash_route.cu's kVec
MAX_CLUSTER = 16         # hash_route.cu's kMaxCluster

_P = ctypes.c_void_p
_READY: set = set()      # device indices whose clusters may exceed 8


def _lib():
    lib = load("hash_route")
    fn = lib.repro_hash_route
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
        lib.repro_hash_route_init.restype = ctypes.c_int
    return lib


def grid_blocks(n: int) -> int:
    """Blocks of a launch, all one cluster: the least power of two that
    gives n at VEC elements a thread, at most MAX_CLUSTER."""
    blocks = 1
    while blocks < MAX_CLUSTER and blocks * THREADS * VEC < n:
        blocks *= 2
    return blocks


def hash_route_kernel(pos: torch.Tensor, valid: torch.Tensor,
                      n_shards: int):
    """One launch on the current stream.

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
    if dev.index not in _READY:
        with torch.cuda.device(dev):
            check_launch(_lib().repro_hash_route_init(), "hash_route_kernel")
        _READY.add(dev.index)
    owner = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n_shards, dtype=torch.int32, device=dev)
    err = _lib().repro_hash_route(
        pos.data_ptr(), valid.data_ptr(), owner.data_ptr(),
        counts.data_ptr(), n, n_shards, grid_blocks(n), raw_stream(pos))
    check_launch(err, "hash_route_kernel")
    return owner, counts
