"""``burst_issue_ms``: the mean host duration of the port's own burst span
(``queue:burst``, ``pqueue:burst``; ``repro_torch.obs.trace``) over the
window's bursts outside the profiled stretch: the host's time to issue a
burst's work, which the device does not wait for while it stays below
the burst's device time."""


def read(run):
    if not run.spans:
        return None
    return sum(s["dur"] for s in run.spans) / len(run.spans) / 1e3
