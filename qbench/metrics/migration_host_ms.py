"""``migration_host_ms``: the mean of the port's own migration ``host_s``
(the ``grow`` or ``shrink`` call's time outside its synchronised
migration wave: the capacity guard, the moved/lost read, the new state
and the hash-balance report) over the window's JOINs and LEAVEs."""


def read(run):
    host = [r.stats["host_s"] for r in run.resizes if "host_s" in r.stats]
    if not host:
        return None
    return sum(host) / len(host) * 1e3
