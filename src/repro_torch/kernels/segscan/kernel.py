"""Launchers of the CUDA segscan kernels, ``csrc/segscan.cu``.

Replace ``repro/kernels/segscan/kernel.py``: ``queue_scan_kernel`` (FIFO
min-plus), ``stack_scan_kernel`` (LIFO max-plus) and
``tiered_queue_scan_kernel`` (the per-tier enqueue sweep).  The CUDA
source says what bounds them and how they are built; this module checks
the tensors and passes pointers.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, stream_ptr

BLOCK = 1024   # ops per block, one per thread (must match segscan.cu)
MAX_TIERS = 256   # the tiered emit's shared memory, 32 * P int32 (< 48 KB)

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_queue_scan": [_P] * 9 + [ctypes.c_int, _P],
    "repro_stack_scan": [_P] * 10 + [ctypes.c_int, _P],
    "repro_tiered_scan": [_P] * 7 + [ctypes.c_int, ctypes.c_int, _P],
}


def _fn(name: str):
    fn = getattr(load("segscan"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, n_max: int, n: int, vecs, scalars):
    """Raise unless ``vecs`` are contiguous [n] tensors and ``scalars``
    0-d ones, each of its dtype, all on one device."""
    dev = vecs[0][1].device
    for name, t, dt in vecs + scalars:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if any(t.shape != (n,) for _, t, _ in vecs) or any(
            t.dim() for _, t, _ in scalars):
        raise ValueError(f"{what}: per-op inputs must be [n], the state "
                         f"scalars 0-d")
    if n >= n_max:
        raise ValueError(f"{what}: n must stay below {n_max} (the INF "
                         f"saturation bound)")


def queue_scan_kernel(is_enq: torch.Tensor, valid: torch.Tensor,
                      first: torch.Tensor, last: torch.Tensor):
    """Three launches on the current stream: block totals, one block's
    exclusive scan of them (which also writes the new state), and the
    per-block scan that emits positions.  No host sync.

    is_enq/valid: [n] bool, contiguous, on one CUDA device; first/last:
    0-d int32 on the same device.  Returns (pos [n] int32, matched [n]
    bool, new_first, new_last), the last two 0-d int32 on the device.
    """
    n = is_enq.shape[0]
    _check("queue_scan_kernel", 2 ** 30, n,
           [("is_enq", is_enq, torch.bool), ("valid", valid, torch.bool)],
           [("first", first, torch.int32), ("last", last, torch.int32)])
    dev = is_enq.device
    nb = max(-(-n // BLOCK), 1)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    new_state = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(6 * nb, dtype=torch.int32, device=dev)
    err = _fn("repro_queue_scan")(
        is_enq.data_ptr(), valid.data_ptr(), first.data_ptr(),
        last.data_ptr(), pos.data_ptr(), matched.data_ptr(),
        new_state.data_ptr(), scratch.data_ptr(),
        scratch[3 * nb:].data_ptr(), n, stream_ptr(pos))
    check_launch(err, "queue_scan_kernel")
    return pos, matched, new_state[0], new_state[1]


def stack_scan_kernel(is_push: torch.Tensor, valid: torch.Tensor,
                      last: torch.Tensor, ticket: torch.Tensor):
    """The LIFO max-plus scan, three launches as :func:`queue_scan_kernel`.

    is_push/valid: [n] bool; last/ticket: 0-d int32, all on one CUDA
    device.  Returns (pos [n] int32 with ⊥ = -1, tick [n] int32, matched
    [n] bool, new_last, new_ticket).  Raises at n >= 2^29, where garbage
    below -INF + n could reach a real stack height.
    """
    n = is_push.shape[0]
    _check("stack_scan_kernel", 2 ** 29, n,
           [("is_push", is_push, torch.bool), ("valid", valid, torch.bool)],
           [("last", last, torch.int32), ("ticket", ticket, torch.int32)])
    dev = is_push.device
    nb = max(-(-n // BLOCK), 1)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    tick = torch.empty(n, dtype=torch.int32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    new_state = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(6 * nb, dtype=torch.int32, device=dev)
    err = _fn("repro_stack_scan")(
        is_push.data_ptr(), valid.data_ptr(), last.data_ptr(),
        ticket.data_ptr(), pos.data_ptr(), tick.data_ptr(),
        matched.data_ptr(), new_state.data_ptr(), scratch.data_ptr(),
        scratch[3 * nb:].data_ptr(), n, stream_ptr(pos))
    check_launch(err, "stack_scan_kernel")
    return pos, tick, matched, new_state[0], new_state[1]


def tiered_queue_scan_kernel(enq: torch.Tensor, tier: torch.Tensor,
                             lasts: torch.Tensor):
    """The per-tier enqueue sweep: three launches (block tier counts, one
    block per tier scanning them, emit).

    enq: [n] bool; tier: [n] int32; lasts: [P] int32, all on one CUDA
    device, 1 <= P <= 256.  Returns (pos [n] int32, -1 for a non-enqueue
    or a tier outside [0, P); new_lasts [P] int32).
    """
    n, P = enq.shape[0], lasts.shape[0]
    _check("tiered_queue_scan_kernel", 2 ** 30, n,
           [("enq", enq, torch.bool), ("tier", tier, torch.int32)], [])
    if (lasts.dtype != torch.int32 or lasts.dim() != 1
            or lasts.device != enq.device or not lasts.is_contiguous()):
        raise ValueError("tiered_queue_scan_kernel: lasts must be a "
                         "contiguous [P] int32 tensor on the ops' device")
    if not 1 <= P <= MAX_TIERS:
        raise ValueError(f"tiered_queue_scan_kernel: P must be in "
                         f"[1, {MAX_TIERS}], got {P}")
    dev = enq.device
    nb = max(-(-n // BLOCK), 1)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    new_lasts = torch.empty(P, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * P * nb, dtype=torch.int32, device=dev)
    err = _fn("repro_tiered_scan")(
        tier.data_ptr(), enq.data_ptr(), lasts.data_ptr(), pos.data_ptr(),
        new_lasts.data_ptr(), scratch.data_ptr(),
        scratch[P * nb:].data_ptr(), n, P, stream_ptr(pos))
    check_launch(err, "tiered_queue_scan_kernel")
    return pos, new_lasts
