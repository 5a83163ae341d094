"""Launcher of the CUDA FIFO scan, ``csrc/segscan.cu``.

Replaces ``repro/kernels/segscan/kernel.py:queue_scan_kernel`` (Pallas,
bodies ``_totals_kernel`` and ``_scan_kernel``, the carry scan in jnp
between them).  The CUDA source says what bounds it and how it is built;
this module checks the tensors and passes pointers.
"""
from __future__ import annotations

import ctypes

import torch

from ..backend import check_launch, load, stream_ptr

BLOCK = 1024   # ops per block, one per thread (must match segscan.cu)

_P = ctypes.c_void_p


def _lib():
    lib = load("segscan")
    fn = lib.repro_queue_scan
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return lib


def queue_scan_kernel(is_enq: torch.Tensor, valid: torch.Tensor,
                      first: torch.Tensor, last: torch.Tensor):
    """Three launches on the current stream: block totals, one block's
    exclusive scan of them (which also writes the new state), and the
    per-block scan that emits positions.  No host sync.

    is_enq/valid: [n] bool, contiguous, on one CUDA device; first/last:
    0-d int32 on the same device.  Returns (pos [n] int32, matched [n]
    bool, new_first, new_last), the last two 0-d int32 on the device.
    """
    dev = is_enq.device
    n = is_enq.shape[0]
    for name, t, dt in (("is_enq", is_enq, torch.bool),
                        ("valid", valid, torch.bool),
                        ("first", first, torch.int32),
                        ("last", last, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"queue_scan_kernel: {name} must be a "
                             f"contiguous {dt} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if valid.shape != (n,) or is_enq.dim() != 1 or first.dim() or last.dim():
        raise ValueError("queue_scan_kernel: is_enq/valid must be [n], "
                         "first/last 0-d")
    if n >= 2 ** 30:
        raise ValueError("queue_scan_kernel: n must stay below 2^30 "
                         "(the INF saturation bound)")
    nb = -(-n // BLOCK)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    new_state = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(6 * max(nb, 1), dtype=torch.int32, device=dev)
    err = _lib().repro_queue_scan(
        is_enq.data_ptr(), valid.data_ptr(), first.data_ptr(),
        last.data_ptr(), pos.data_ptr(), matched.data_ptr(),
        new_state.data_ptr(), scratch.data_ptr(),
        scratch[3 * max(nb, 1):].data_ptr(), n, stream_ptr(pos))
    check_launch(err, "queue_scan_kernel")
    return pos, matched, new_state[0], new_state[1]
