"""Launchers of the CUDA segscan kernels, ``csrc/segscan.cu``.

Replace ``repro/kernels/segscan/kernel.py``: ``queue_scan_kernel`` (FIFO
min-plus), ``stack_scan_kernel`` (LIFO max-plus) and
``tiered_queue_scan_kernel`` (the per-tier enqueue sweep).  The CUDA
source says what bounds them and how they are built; this module checks
the tensors, keeps the look-back status buffers and passes pointers;
``tier_groups`` splits a sweep wider than one launch takes.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, raw_stream

# Tile shapes, as segscan.cu's constants (a test reads them there)
TILE = 4096                 # ops per tile, every scan
QUEUE_THREADS = 256         # queue_scan_lookback: 16 ops a thread
STACK_THREADS = 128         # stack_scan_lookback: 32 ops a thread
TIER_THREADS = 256          # tiered_scan_lookback: 16 ops a thread
MAX_TIERS = TIER_THREADS    # tiers one tiered launch takes: one a thread

_P = ctypes.c_void_p
_ARGTYPES = {
    "repro_queue_scan": [_P] * 8 + [ctypes.c_int, ctypes.c_ulonglong,
                                    ctypes.c_int, _P],
    "repro_stack_scan": [_P] * 9 + [ctypes.c_int, ctypes.c_ulonglong,
                                    ctypes.c_int, _P],
    "repro_tiered_scan": [_P] * 6 + [ctypes.c_int, ctypes.c_ulonglong,
                                     ctypes.c_int, ctypes.c_int, _P],
}
# (device index, stream) -> (uint8 status buffer, flag slots, last epoch)
_STATUS: dict = {}


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


def _status(device: torch.device, stream: int, n: int, width: int):
    """The look-back status buffer of ``(device, stream)``, its number of
    flag slots, and this call's epoch.

    Layout (``status_view`` in segscan.cu): a 16-byte tile counter,
    ``slots`` uint64 flags, then aggregates and inclusive prefixes of
    ``width`` int32 for each of this call's tiles.  The buffer is zeroed
    once, when it is allocated or grown (each part to at least twice its
    size); between calls nothing clears it: each call raises the epoch,
    and the kernel reads a flag below ``2 * epoch`` as unset.  Calls on
    one stream run in order, so the FIFO, stack and tiered scans share a
    buffer safely; a dropped buffer is reused by the allocator only after
    the work queued on its stream.  Raises under CUDA-graph capture: a
    replay would repeat the captured epoch, and flags of the previous
    replay would read as this call's.
    """
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the segscan kernels cannot be captured in a CUDA graph: each "
            "call raises a host-side epoch that a replay would repeat")
    tiles = max(-(-n // TILE), 1)
    key = (device.index, stream)
    buf, slots, epoch = _STATUS.get(key, (None, 0, 0))
    values = buf.numel() - 16 - 8 * slots if buf is not None else 0
    if tiles > slots or 8 * tiles * width > values:
        slots = max(2 * slots, tiles + tiles % 2)
        values = max(2 * values, 8 * tiles * width)
        buf = torch.zeros(16 + 8 * slots + values, dtype=torch.uint8,
                          device=device)
    _STATUS[key] = (buf, slots, epoch + 1)
    return buf, slots, epoch + 1


def queue_scan_kernel(is_enq: torch.Tensor, valid: torch.Tensor,
                      first: torch.Tensor, last: torch.Tensor):
    """The FIFO min-plus scan: one single-pass launch on the current
    stream (decoupled look-back), no host sync.

    is_enq/valid: [n] bool; first/last: 0-d int32, all on one CUDA
    device.  Returns (pos [n] int32 with ⊥ = -1, matched [n] bool,
    new_first, new_last); pos and the state are views of one allocation.
    """
    n = is_enq.shape[0]
    _check("queue_scan_kernel", 2 ** 30, n,
           [("is_enq", is_enq, torch.bool), ("valid", valid, torch.bool)],
           [("first", first, torch.int32), ("last", last, torch.int32)])
    dev = is_enq.device
    stream = raw_stream(is_enq)
    status, slots, epoch = _status(dev, stream, n, 4)
    out = torch.empty(n + 2, dtype=torch.int32, device=dev)
    pos, state = out.split((n, 2))
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    err = _fn("repro_queue_scan")(
        is_enq.data_ptr(), valid.data_ptr(), first.data_ptr(),
        last.data_ptr(), pos.data_ptr(), matched.data_ptr(),
        state.data_ptr(), status.data_ptr(), slots, epoch, n, stream)
    check_launch(err, "queue_scan_kernel")
    new_first, new_last = state.unbind()
    return pos, matched, new_first, new_last


def stack_scan_kernel(is_push: torch.Tensor, valid: torch.Tensor,
                      last: torch.Tensor, ticket: torch.Tensor):
    """The LIFO max-plus scan: one single-pass launch on the current
    stream (decoupled look-back), no host sync.

    is_push/valid: [n] bool; last/ticket: 0-d int32, all on one CUDA
    device.  Returns (pos [n] int32 with ⊥ = -1, tick [n] int32, matched
    [n] bool, new_last, new_ticket); pos, tick and the state are views of
    one allocation.  Raises at n >= 2^29, where garbage below -INF + n
    could reach a real stack height.
    """
    n = is_push.shape[0]
    _check("stack_scan_kernel", 2 ** 29, n,
           [("is_push", is_push, torch.bool), ("valid", valid, torch.bool)],
           [("last", last, torch.int32), ("ticket", ticket, torch.int32)])
    dev = is_push.device
    stream = raw_stream(is_push)
    status, slots, epoch = _status(dev, stream, n, 4)
    pad = -n % 4                       # tick starts 16-byte aligned
    out = torch.empty(2 * (n + pad) + 2, dtype=torch.int32, device=dev)
    if pad:
        pos, _, tick, _, state = out.split((n, pad, n, pad, 2))
    else:
        pos, tick, state = out.split((n, n, 2))
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    err = _fn("repro_stack_scan")(
        is_push.data_ptr(), valid.data_ptr(), last.data_ptr(),
        ticket.data_ptr(), pos.data_ptr(), tick.data_ptr(),
        matched.data_ptr(), state.data_ptr(), status.data_ptr(), slots,
        epoch, n, stream)
    check_launch(err, "stack_scan_kernel")
    new_last, new_ticket = state.unbind()
    return pos, tick, matched, new_last, new_ticket


def tier_groups(scan, enq: torch.Tensor, tier: torch.Tensor,
                lasts: torch.Tensor, group: int = MAX_TIERS):
    """The tiered sweep over any number of tiers P, ``group`` at a time.

    ``scan(enq, tier, lasts)`` is a sweep of at most ``group`` tiers
    (``(pos [n], new_lasts)``; -1 for an op outside its tiers).  At P <=
    ``group`` it is called once on the inputs as they are.  Otherwise group
    g sees the tiers re-based by ``g * group`` (so the group's tiers are
    ``[0, group)`` and every other tier, out-of-range ones included, falls
    outside) and ``lasts[g * group : (g + 1) * group]``; exactly one group
    places each op that takes a position, and every other group gives it
    -1, so the groups' positions merge by ``where`` and their new lasts
    concatenate.  Tiers are independent, so the result is the one sweep's.
    """
    P = lasts.shape[0]
    if P <= group:
        return scan(enq, tier, lasts)
    pos, new_lasts = None, []
    for g0 in range(0, P, group):
        p, nl = scan(enq, tier - g0 if g0 else tier, lasts[g0:g0 + group])
        pos = p if pos is None else torch.where(p != -1, p, pos)
        new_lasts.append(nl)
    return pos, torch.cat(new_lasts)


def tiered_queue_scan_kernel(enq: torch.Tensor, tier: torch.Tensor,
                             lasts: torch.Tensor):
    """The per-tier enqueue sweep of at most 256 tiers: one single-pass
    launch on the current stream, as :func:`stack_scan_kernel`, no host
    sync.  The wrapper makes one launch per group of 256 tiers past that
    (:func:`tier_groups`).

    enq: [n] bool; tier: [n] int32; lasts: [P] int32, all on one CUDA
    device, 1 <= P <= 256.  Returns (pos [n] int32, -1 for a non-enqueue
    or a tier outside [0, P); new_lasts [P] int32), views of one
    allocation.
    """
    n, P = enq.shape[0], lasts.shape[0]
    _check("tiered_queue_scan_kernel", 2 ** 30, n,
           [("enq", enq, torch.bool), ("tier", tier, torch.int32)], [])
    if (lasts.dtype != torch.int32 or lasts.dim() != 1
            or lasts.device != enq.device or not lasts.is_contiguous()):
        raise ValueError("tiered_queue_scan_kernel: lasts must be a "
                         "contiguous [P] int32 tensor on the ops' device")
    if not 1 <= P <= MAX_TIERS:
        raise ValueError(f"tiered_queue_scan_kernel: P must be in [1, "
                         f"{MAX_TIERS}], got {P}")
    dev = enq.device
    stream = raw_stream(enq)
    status, slots, epoch = _status(dev, stream, n, P)
    pad = -n % 4
    out = torch.empty(n + pad + P, dtype=torch.int32, device=dev)
    if pad:
        pos, _, new_lasts = out.split((n, pad, P))
    else:
        pos, new_lasts = out.split((n, P))
    err = _fn("repro_tiered_scan")(
        tier.data_ptr(), enq.data_ptr(), lasts.data_ptr(), pos.data_ptr(),
        new_lasts.data_ptr(), status.data_ptr(), slots, epoch, n, P, stream)
    check_launch(err, "tiered_queue_scan_kernel")
    return pos, new_lasts
