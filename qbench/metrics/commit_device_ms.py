"""``commit_device_ms``: device milliseconds a wave of the operations
launched inside the wave engine's ``wave:commit`` stage spans (the
Stage-4 store rewrite and the reply; ``repro_torch.dqueue.wave_engine``),
over the waves of the profiled stretch.  Nothing unless the stretch shows
K + 1 such ranges a pipelined K-wave burst."""


def read(run):
    if run.trace is None:
        return None
    us, n_ranges = run.trace.device_us_within({"wave:commit"})
    waves = sum(b.K for b in run.profiled)
    if us <= 0 or n_ranges != waves + len(run.profiled):
        return None
    return us / 1e3 / waves
