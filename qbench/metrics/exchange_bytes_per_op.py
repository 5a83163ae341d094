"""``exchange_bytes_per_op``: the bytes the port passed to its runtime's
exchange over its op slots, summed over the window's burst spans outside
the profiled stretch (their ``exchange_bytes`` and ``ops`` args, recorded
at the span's close from ``Runtime.exchange_bytes``).  Nothing where the
spans carry no such args."""


def read(run):
    spans = [s["args"] for s in run.spans
             if "exchange_bytes" in s["args"] and "ops" in s["args"]]
    ops = sum(a["ops"] for a in spans)
    if not ops:
        return None
    return sum(a["exchange_bytes"] for a in spans) / ops
