"""wavecheck for the port: the device wave path's invariants, in torch terms.

Counterpart of ``repro/analysis``.  Five rule families:

1. ``budgets``   — per-program collective budgets: the exchanges and
                   gathers one call makes through the runtime seam
                   (``Runtime.exchange``/``gather``, :mod:`.seam`), in
                   place of the reference's HLO op walk;
2. ``donation``  — the store tensors a wave updates in place keep their
                   storage, and a migration releases the old store
                   (``data_ptr`` and ``weakref``, in place of XLA's
                   input-output aliases);
3. ``recompile`` — a rebuild tracker (libraries compiled, inner
                   structures built, segscan status buffers regrown,
                   CUDA memory reserved) asserting that an elastic
                   queue bouncing between shard counts, burst lengths
                   and ladder widths rebuilds nothing the second time;
4. ``overflow``  — an int32-overflow taint lint over the aten graphs
                   (``make_fx``) of the ``core/scan_queue.py``
                   tropical-semiring arithmetic and the Seap midpoint;
5. ``astlint``   — a repo AST lint: no host sync or host callback in a
                   wave method, no sync inside a burst loop, no bare
                   ``assert``, no direct device construction above the
                   runtime seam.

CLI: ``python -m repro_torch.analysis --all [--device cuda] [--shards 8]``
(JSON report, non-zero exit on any violation); ``--selftest`` runs the
mutation self-test (a deliberately broken discipline must trip >= 3
families, ``collective_budget`` and ``donation`` among them).  The
port's own ``doclint`` is ``python -m repro_torch.analysis.doclint``.

Names are resolved lazily, as in the reference.
"""
from typing import Any

__all__ = [
    "collective_counts", "count_exchanges", "Violation", "CollectiveBudget",
    "check_budget", "check_donation", "check_released", "RebuildTracker",
    "check_recompile_guard", "check_int32_overflow", "lint_fn",
    "lint_paths", "run_all", "run_selftest",
]

_LAZY = {
    "collective_counts": "seam", "count_exchanges": "seam",
    "Violation": "report",
    "CollectiveBudget": "budgets", "check_budget": "budgets",
    "check_donation": "donation", "check_released": "donation",
    "RebuildTracker": "recompile", "check_recompile_guard": "recompile",
    "check_int32_overflow": "overflow", "lint_fn": "overflow",
    "lint_paths": "astlint",
    "run_all": "runner",
    "run_selftest": "selftest",
}


def __getattr__(name: str) -> Any:
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
