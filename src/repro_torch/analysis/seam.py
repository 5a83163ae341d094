"""The runtime seam as wavecheck's collective counter (in place of hlo.py).

The reference counts collectives by walking the compiled HLO of each
jitted entry point (``repro/analysis/hlo.py``).  Eager torch compiles no
module; instead every cross-shard transfer of the port goes through one
of the runtime's two counted seams, ``Runtime.exchange`` (the
reference's ``all_to_all``) and ``Runtime.gather`` (its ``all_gather``):
``runtime/local.py`` and ``runtime/distributed.py`` raise
``n_exchanges`` and ``n_gathers`` there and nowhere else.  So the
collectives a call makes are the deltas of those two counters around
it, keyed ``"exchange"`` and ``"gather"``.  The counts are dynamic: a
K-wave burst shows K + 1 exchanges where the reference's static walk of
one scanned body shows at most 2.

Beside them, on a CUDA runtime, :func:`collective_counts` reads the
launches of the queue kernels over the same call (the segscan and
relaxed wrappers' ``launches`` counters, which they raise only where
they launch); on the CPU the wrappers run their plain versions and the
launches are reported as ``{}``.
"""
from __future__ import annotations

from typing import Dict

# the queue kernels whose wrappers count their CUDA launches
KERNELS = ("queue_scan", "stack_scan", "tiered_queue_scan",
           "relaxed_deletemin")


def kernel_launches() -> Dict[str, int]:
    """The queue kernels' wrapper launch counters, as they stand."""
    from ..kernels.relaxed import relaxed_deletemin
    from ..kernels.segscan import queue_scan, stack_scan, tiered_queue_scan
    fns = (queue_scan, stack_scan, tiered_queue_scan, relaxed_deletemin)
    return {k: f.launches for k, f in zip(KERNELS, fns)}


class SeamCounts:
    """The seam's counts of a ``with`` block: ``counts`` (``{"exchange":
    n, "gather": m}``) and, on a CUDA runtime, the queue kernels'
    ``launches`` (``{}`` elsewhere)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.counts: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}

    def __enter__(self) -> "SeamCounts":
        rt = self.runtime
        self._ex, self._ga = rt.n_exchanges, rt.n_gathers
        self._cuda = rt.device.type == "cuda"
        self._k = kernel_launches() if self._cuda else {}
        return self

    def __exit__(self, *exc) -> None:
        rt = self.runtime
        self.counts = {"exchange": rt.n_exchanges - self._ex,
                       "gather": rt.n_gathers - self._ga}
        if self._cuda:
            now = kernel_launches()
            self.launches = {k: now[k] - self._k[k] for k in KERNELS}


def collective_counts(runtime) -> SeamCounts:
    """``with collective_counts(runtime) as c: ...`` leaves the block's
    exchanges and gathers in ``c.counts`` and its kernel launches in
    ``c.launches``: the counterpart of the reference's
    ``collective_counts`` of a compiled module."""
    return SeamCounts(runtime)


def count_exchanges(fn, *args) -> int:
    """The exchanges one call ``fn(*args)`` of a structure's bound method
    makes through the seam (``fn.__self__.runtime``): the counterpart of
    ``count_all_to_all``."""
    with collective_counts(fn.__self__.runtime) as c:
        fn(*args)
    return c.counts["exchange"]
