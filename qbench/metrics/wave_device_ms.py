"""``wave_device_ms``: device milliseconds a wave of the operations
launched inside the port's burst spans (``record_function`` ranges of
the same name), over the waves of the profiled stretch."""


def read(run):
    if run.trace is None:
        return None
    span = f"wave:{run.adapter.SPAN}"
    us, n_ranges = run.trace.device_us_within({span})
    waves = sum(b.K for b in run.profiled)
    if us <= 0 or n_ranges != len(run.profiled):
        return None
    return us / 1e3 / waves
