"""Run every wavecheck rule family and assemble the JSON report.

Counterpart of ``repro/analysis/runner.py``: one call of each registered
program (:mod:`.programs`) serves the collective budget and the
held-in-place check; then the rebuild guard, the int32 lint and the AST
lint.
"""
from __future__ import annotations

import statistics
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

from ..kernels.backend import resolve_device
from .astlint import lint_paths
from .budgets import check_budget
from .donation import check_donation, check_released, storage_ptrs
from .overflow import check_int32_overflow
from .programs import CAPS, build_migration_programs, build_programs
from .recompile import bounce_sizes, check_recompile_guard
from .report import Violation, build_report
from .seam import collective_counts


def _run_program(spec, repeats: int):
    """``repeats`` calls of one program (a migration: one); every call's
    counts checked.  Returns (violations, the last call's counts and
    kernel launches, wall ms of each call, and the fields where its CPU
    replay differed with the replay's host ms: ``None`` if not
    replayed)."""
    out: List[Violation] = []
    walls: List[float] = []
    counts: Dict[str, int] = {}
    launches: Dict[str, int] = {}
    replayed: Optional[tuple] = None
    calls = max(1, repeats) if not spec.release else 1
    replay = spec.replay if spec.runtime.device.type != "cpu" else None
    for i in range(calls):
        args = spec.prepare()
        verify = replay(args) if replay and i == calls - 1 else None
        if spec.release:
            refs = {k: weakref.ref(t) for k, t in spec.stores().items()}
        else:
            before = storage_ptrs(spec.stores())
        spec.runtime.sync()
        t0 = time.perf_counter()
        with collective_counts(spec.runtime) as c:
            spec.run(args)
        spec.runtime.sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        del args
        counts = c.counts
        launches = c.launches
        out += check_budget(spec.name, c.counts, spec.budget)
        out += (check_released(spec.name, refs) if spec.release else
                check_donation(spec.name, before,
                               storage_ptrs(spec.stores()), spec.held))
        if verify is not None:
            t0 = time.perf_counter()
            bad = verify()
            replayed = (bad, (time.perf_counter() - t0) * 1e3)
            if bad:
                out.append(Violation(
                    "cpu_replay", spec.name,
                    f"differs from the same call on the CPU in {bad}",
                    {"fields": bad}))
    return out, counts, launches, walls, replayed


def run_all(*, device="cuda", n_shards: int = 8, L: int = 2, W: int = 2,
            K: int = 3, n_prios: int = 3, n_buckets: int = 4,
            slot_depth: int = 4, caps: Dict[str, int] = CAPS,
            relaxation: int = 0, repeats: int = 1,
            recompile: Optional[dict] = None,
            skip_recompile: bool = False) -> Dict[str, Any]:
    """The five rule families over every program at ``n_shards`` shards of
    width ``L`` (defaults: the reference's shape, 35 programs).  ``caps``
    sets the slots per shard of each discipline, ``relaxation`` the
    priority programs'; ``repeats`` calls each wave program that many
    times (each checked; ``wall_ms`` is their median; off the CPU, the
    last call of each narrower-wave program is also replayed on the CPU
    and must agree, the port's own ``cpu_replay`` rule); ``recompile`` the
    bounce (:func:`~.recompile.bounce_sizes`'s keys; default the
    reference's bounce at ``n_shards``)."""
    dev = resolve_device(device)
    violations: List[Violation] = []
    programs: Dict[str, Dict[str, Any]] = {}
    sizes = dict(n_shards=n_shards, L=L, W=W, n_prios=n_prios,
                 n_buckets=n_buckets, slot_depth=slot_depth, caps=caps)
    specs = (build_programs(K=K, device=dev, relaxation=relaxation, **sizes)
             + build_migration_programs(device=dev, **sizes))
    for spec in specs:
        vs, counts, launches, walls, replayed = _run_program(spec, repeats)
        violations += vs
        programs[spec.name] = {
            "collectives": counts, "launches": launches,
            "held": spec.held, "donated_leaves": spec.donated_leaves,
            "left_out": spec.left_out,
            "wall_ms": statistics.median(walls), **spec.meta}
        if replayed is not None:
            programs[spec.name].update(cpu_replay=replayed[0] or "equal",
                                       cpu_replay_ms=replayed[1])
    del specs

    recompile_info: Dict[str, Any] = {}
    if not skip_recompile:
        vs, recompile_info = check_recompile_guard(
            dev, recompile or bounce_sizes(n_shards))
        violations += vs

    vs, overflow_info = check_int32_overflow()
    violations += vs

    vs, ast_info = lint_paths()
    violations += vs

    return build_report(violations, programs, {
        "device": str(dev),
        "n_shards": n_shards,
        "torch_version": torch.__version__,
        "sizes": {**sizes, "K": K, "relaxation": relaxation,
                  "repeats": repeats},
        "recompile_guard": recompile_info,
        "int32_overflow": overflow_info,
        "repo_ast": ast_info,
    })
