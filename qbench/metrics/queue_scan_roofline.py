"""``queue_scan_roofline``: the FIFO scan kernel's (``queue_scan_lookback``,
one launch a wave) share of its memory roofline over the profiled
stretch: the bytes its waves need (``qbench/roofline.py``) at the card's
peak rate, over its device time."""
from qbench import roofline


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us("queue_scan_lookback")
    waves = [b.n for b in run.profiled for _ in range(b.K)]
    if not us or len(us) != len(waves):
        return None
    n_bytes = sum(roofline.queue_scan_bytes(n) for n in waves)
    return roofline.share_percent(n_bytes, sum(us) * 1e-6)
