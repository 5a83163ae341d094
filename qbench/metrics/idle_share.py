"""``idle_share``: the percent of the profiled stretch in which no device
operation ran (one less the union of the device's intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
