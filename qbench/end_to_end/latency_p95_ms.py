"""``latency_p95_ms``: the 95th percentile, over every op answered in the
window, of the time from the op's due time (its burst's submission: the
loop is closed) to the moment its burst's outputs were complete on the
device, on the host clock."""
from qbench.harness import percentile


def read(run):
    if not run.bursts:
        return None
    return percentile([((b.t_done - b.t_due) * 1e3, b.n_ops)
                       for b in run.bursts], 0.95)
