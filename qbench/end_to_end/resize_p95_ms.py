"""``resize_p95_ms``: the 95th percentile, over every JOIN and LEAVE in the
window, of the time the structure took no wave: from the ``grow`` or
``shrink`` call to its return with the device synchronised."""
from qbench.harness import percentile


def read(run):
    if not run.resizes:
        return None
    return percentile([((r.t_done - r.t_due) * 1e3, 1)
                       for r in run.resizes], 0.95)
