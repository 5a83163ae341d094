"""``tiered_scan_roofline``: the tiered scan kernel's
(``tiered_scan_lookback``, one launch a wave for up to 256 tiers) share
of its memory roofline over the profiled stretch: the bytes its waves
need (``qbench/roofline.py``) at the card's peak rate, over its device
time."""
from qbench import roofline


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us("tiered_scan_lookback")
    waves = [b.n for b in run.profiled for _ in range(b.K)]
    if not us or len(us) != len(waves):
        return None
    P = int(run.cfg["n_prios"])
    n_bytes = sum(roofline.tiered_scan_bytes(n, P) for n in waves)
    return roofline.share_percent(n_bytes, sum(us) * 1e-6)
