"""Launcher of the CUDA Stage-4 store rewrite, ``csrc/ring_commit.cu``.

The CUDA source says what bounds it; this module checks the tensors, picks
the cluster size and passes pointers and the receive buffer's strides.
One launch a call: the reply and the overflow flag come from
``torch.empty`` and the kernel writes all of both, so nothing is kept
between calls.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, raw_stream

THREADS = 256        # ring_commit.cu's kThreads
UNROLL = 4           # rows a thread loads at once; ring_commit.cu's kUnroll
MAX_CLUSTER = 8      # ring_commit.cu's kMaxCluster: the portable limit
LIST_CAP = 2048      # GET rows a block lists; ring_commit.cu's kListCap
BLOCKS_PER_SM = 4    # the grid aims at this many blocks an SM

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SMS: dict = {}      # device index -> its streaming multiprocessors


def _lib():
    lib = load("ring_commit")
    fn = lib.repro_ring_commit
    if fn.argtypes is None:
        fn.argtypes = ([_P] + [_I64] * 4 + [_P] * 4 + [ctypes.c_int] * 6
                       + [_P])
        fn.restype = ctypes.c_int
    return lib


def cluster_blocks(n_dst: int, rows: int, n_sms: int) -> int:
    """Blocks a destination shard's cluster holds: doubled from 1 while
    the grid is under ``BLOCKS_PER_SM`` blocks an SM and the doubled
    blocks keep at least one unrolled pass of rows each, up to
    ``MAX_CLUSTER``."""
    b = 1
    while (b < MAX_CLUSTER and n_dst * b < BLOCKS_PER_SM * n_sms
           and rows >= 2 * b * THREADS * UNROLL):
        b *= 2
    return b


def ring_commit_kernel(store, recv: torch.Tensor, junk: int, W: int):
    """One launch on the current stream.

    store: (store_vals [n, junk+1, W] int32, store_full [n, junk+1] bool),
    contiguous; recv: [n, n_src, L, 2+W] int32 with non-negative strides
    (a view of a wider buffer, or an ``expand``), on the same CUDA device.
    Returns (store, reply [n, n_src, L, 1+W] int32, overflow: 0-d bool).
    """
    sv, sf = store
    dev = recv.device
    if recv.dtype != torch.int32 or sv.dtype != torch.int32 \
            or sf.dtype != torch.bool:
        raise ValueError("ring_commit_kernel: recv and store_vals must be "
                         "int32 and store_full bool, got "
                         f"{recv.dtype}, {sv.dtype}, {sf.dtype}")
    if sv.device != dev or sf.device != dev:
        raise ValueError("ring_commit_kernel: store and recv must be on "
                         "one device")
    n = sv.shape[0]
    if (recv.dim() != 4 or recv.shape[0] != n or recv.shape[3] != 2 + W
            or W < 1 or junk < 0):
        raise ValueError(f"ring_commit_kernel: recv must be [{n}, n_src, "
                         f"L, {2 + W}] with W >= 1, got {tuple(recv.shape)}"
                         f" (W={W}, junk={junk})")
    if (sv.shape != (n, junk + 1, W) or sf.shape != (n, junk + 1)
            or not (sv.is_contiguous() and sf.is_contiguous())):
        raise ValueError(f"ring_commit_kernel: store must be contiguous "
                         f"[{n}, {junk + 1}, {W}] and [{n}, {junk + 1}], "
                         f"got {tuple(sv.shape)} and {tuple(sf.shape)}")
    if min(recv.stride()) < 0:
        raise ValueError("ring_commit_kernel: recv's strides must be "
                         f"non-negative, got {recv.stride()}")
    n_src, L = recv.shape[1], recv.shape[2]
    rows = n_src * L
    if rows >= 2 ** 31 or (junk + 1) * W >= 2 ** 31:
        raise ValueError(f"ring_commit_kernel: {rows} rows a shard and "
                         f"{junk + 1} slots of {W} words must each stay "
                         "under 2^31")
    reply = torch.empty((n, n_src, L, 1 + W), dtype=torch.int32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    if n == 0:
        ovf.fill_(False)
        return (sv, sf), reply, ovf
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    blocks = cluster_blocks(n, rows, _SMS[dev.index])
    err = _lib().repro_ring_commit(
        recv.data_ptr(), *recv.stride(), sv.data_ptr(), sf.data_ptr(),
        reply.data_ptr(), ovf.data_ptr(), n, n_src, L, W, junk, blocks,
        raw_stream(recv))
    check_launch(err, "ring_commit_kernel")
    return (sv, sf), reply, ovf
