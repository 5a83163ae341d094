"""Violation record and JSON report assembly shared by all rule families.

Counterpart of ``repro/analysis/report.py``: the same fields and the same
``"tool": "wavecheck"`` report.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List


@dataclass(frozen=True)
class Violation:
    """One broken contract, attributable to a rule family and a program
    (a wave entry point, a traced function, or a source file)."""
    rule: str        # "collective_budget" | "donation" | "recompile_guard"
                     # | "int32_overflow" | "repo_ast" | "cpu_replay"
    program: str     # e.g. "queue.step", "core/scan_queue.py:seap_queue_scan"
    message: str
    detail: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:
        return f"[{self.rule}] {self.program}: {self.message}"


RULE_FAMILIES = ("collective_budget", "donation", "recompile_guard",
                 "int32_overflow", "repo_ast")
# the port's own: a narrower-wave program's answers on the device differ
# from the same call's on the CPU (checked only off the CPU)
PORT_RULES = ("cpu_replay",)


def build_report(violations: List[Violation],
                 programs: Dict[str, Dict[str, Any]],
                 info: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON-ready report: verdict, violations by rule family, the
    per-program records and ``info`` (sizes, versions, family details)."""
    by_rule: Dict[str, List[dict]] = {r: [] for r in RULE_FAMILIES + PORT_RULES}
    for v in violations:
        by_rule.setdefault(v.rule, []).append(asdict(v))
    return {
        "tool": "wavecheck",
        "passed": not violations,
        "n_violations": len(violations),
        "violations": [asdict(v) for v in violations],
        "rules": {r: {"violations": vs, "n": len(vs)}
                  for r, vs in by_rule.items()},
        "programs": programs,
        **info,
    }


def to_json(report: Dict[str, Any]) -> str:
    """The report as indented JSON (non-JSON values as strings)."""
    return json.dumps(report, indent=2, sort_keys=False, default=str)
