"""Launcher of the CUDA relaxed tier resolution, ``csrc/relaxed.cu``.

Replaces the reference's ``lax.scan`` in
``repro/core/scan_queue.py:priority_queue_scan``.  The CUDA source says
what bounds it; this module checks the tensors and passes pointers.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, raw_stream

THREADS = 512               # one block; relaxed.cu's kThreads
TILE = 2304                 # ops a producer round; relaxed.cu's kTile
WALK = 256                  # dequeues a walker warp tests; kWalk
WALKERS = 4                 # walker warps; relaxed.cu's kWalkers
WINDOW = WALKERS * WALK     # dequeues a window; relaxed.cu's kWindow
RING = 8192                 # dequeue entries in shared memory; kRing
STATS = 8                   # int64 words the clock build writes; kStats
SMEM_MAX = 227 * 1024       # shared memory one H100 block can use
MAX_SHARDS = 65_536         # low[]'s bits in shared memory above 64
MAX_OPS = 2 ** 30           # the published count keeps a done bit
# relaxed.cu's repro_relaxed_smem: the ring (4 words an entry, 64 spare),
# low[] at MAX_SHARDS (one bit more), 3 words a tier; 512 bytes left for
# the static counters and the walk state
MAX_TIERS = (SMEM_MAX - 4 * (4 * RING + 64) - (MAX_SHARDS // 8 + 4)
             - 512) // 12

_P = ctypes.c_void_p


def _lib():
    lib = load("relaxed")
    fn = lib.repro_relaxed_deletemin
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [ctypes.c_int] * 4 + [_P]
        fn.restype = ctypes.c_int
    return lib


def relaxed_deletemin_kernel(deq: torch.Tensor, shard_of: torch.Tensor,
                             avail: torch.Tensor, firsts: torch.Tensor,
                             n_prios: int, relaxation: int, n_shards: int,
                             stats: torch.Tensor | None = None):
    """One launch on the current stream.

    deq: [n] bool, shard_of: [n] int32, avail/firsts: [P] int32, all
    contiguous on one CUDA device.  Returns (tier, pos, matched, taken,
    n_relaxed) on the device, as :func:`~.ref.relaxed_deletemin_ref`.
    With ``stats`` (an int64 [STATS] tensor on the device) the clock build
    runs instead and writes there its walk steps, relaxed serves, dry
    events, walk cycles (clock64, waits included), the walker's wait
    cycles, the producers' cycles in write-backs before a round, and the
    dequeues walked.
    """
    dev = deq.device
    n, P = deq.shape[0], n_prios
    for name, t, dt, shape in (("deq", deq, torch.bool, (n,)),
                               ("shard_of", shard_of, torch.int32, (n,)),
                               ("avail", avail, torch.int32, (P,)),
                               ("firsts", firsts, torch.int32, (P,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"relaxed_deletemin_kernel: {name} must be a "
                             f"contiguous {dt} {list(shape)} tensor on "
                             f"{dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    if not 1 <= P <= MAX_TIERS:
        raise ValueError(f"relaxed_deletemin_kernel: n_prios must be in "
                         f"[1, {MAX_TIERS}]: three words a tier share the "
                         f"block's shared memory with the 128 KB ring of "
                         f"dequeues, got {P}")
    if relaxation < 0 or not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"relaxed_deletemin_kernel: needs relaxation >= 0 "
                         f"and n_shards in [1, {MAX_SHARDS}]")
    if n >= MAX_OPS:
        raise ValueError(f"relaxed_deletemin_kernel: n must stay below "
                         f"{MAX_OPS}")
    if stats is not None and (stats.device != dev or stats.dtype !=
                              torch.int64 or stats.shape != (STATS,)):
        raise ValueError(f"relaxed_deletemin_kernel: stats must be an int64 "
                         f"[{STATS}] tensor on {dev}")
    tier = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    taken = torch.empty(P, dtype=torch.int32, device=dev)
    n_relaxed = torch.empty((), dtype=torch.int32, device=dev)
    if n == 0:
        return tier, pos, matched, taken.zero_(), n_relaxed.zero_()
    err = _lib().repro_relaxed_deletemin(
        deq.data_ptr(), shard_of.data_ptr(), avail.data_ptr(),
        firsts.data_ptr(), tier.data_ptr(), pos.data_ptr(),
        matched.data_ptr(), taken.data_ptr(), n_relaxed.data_ptr(),
        None if stats is None else stats.data_ptr(), n, P,
        min(relaxation, P), n_shards, raw_stream(deq))
    check_launch(err, "relaxed_deletemin_kernel")
    return tier, pos, matched, taken, n_relaxed
