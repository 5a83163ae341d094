"""``dispatch_device_ms``: device milliseconds a wave of the operations
launched inside the wave engine's ``wave:dispatch`` stage spans (Stages
1-3 and the telemetry row; ``repro_torch.dqueue.wave_engine``), over the
waves of the profiled stretch.  Nothing unless the stretch shows one such
range a wave."""


def read(run):
    if run.trace is None:
        return None
    us, n_ranges = run.trace.device_us_within({"wave:dispatch"})
    waves = sum(b.K for b in run.profiled)
    if us <= 0 or n_ranges != waves:
        return None
    return us / 1e3 / waves
