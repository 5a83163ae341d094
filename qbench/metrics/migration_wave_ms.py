"""``migration_wave_ms``: the mean of the port's own migration ``wave_s``
(the one packed exchange and the store's rewrite, timed between two
device synchronisations) over the window's JOINs and LEAVEs."""


def read(run):
    waves = [r.stats["wave_s"] for r in run.resizes if "wave_s" in r.stats]
    if not waves:
        return None
    return sum(waves) / len(waves) * 1e3
