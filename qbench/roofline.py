"""Peaks of the card and the bytes a kernel call needs.

A call's share of its roofline is the least time the card could take for
it, the bytes its inputs and outputs need at the memory's peak rate (each
input byte read once, each output byte written once), over the time the
call took on the device.  The scans do a few integer operations a byte,
far below the card's integer rate, so the bytes bound them; no operation
count is used.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, HBM3 at 3.35 TB/s, reached at
the card's full power limit of 700 W.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12


def queue_scan_bytes(n: int) -> int:
    """``queue_scan_lookback`` over one wave of ``n`` ops: reads the op
    and valid bits (1 byte each) and the ``first``/``last`` carry (2 x
    int32); writes each op's position (int32) and matched bit (1 byte)
    and the new carry (2 x int32)."""
    return 7 * n + 16


def tiered_scan_bytes(n: int, n_tiers: int) -> int:
    """``tiered_scan_lookback`` over one wave of ``n`` ops and
    ``n_tiers`` tiers: reads each op's enqueue bit (1 byte) and tier
    (int32) and the tiers' ``lasts`` (int32 a tier); writes each op's
    position (int32) and the tiers' new ``lasts`` (int32 a tier)."""
    return 9 * n + 8 * n_tiers


def share_percent(n_bytes: float, device_s: float) -> float:
    """Percent of the memory roofline reached by ``n_bytes`` moved in
    ``device_s`` seconds of device time."""
    return n_bytes / PEAK_BYTES_PER_S / device_s * 100.0
