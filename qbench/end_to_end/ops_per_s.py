"""``ops_per_s``: the valid ops answered in the window (matched or ⊥), over
the window's seconds on the host clock, membership changes included."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(b.n_ops for b in run.bursts) / run.window_s
