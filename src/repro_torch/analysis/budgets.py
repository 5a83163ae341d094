"""Rule family 1: collective budgets.

Counterpart of ``repro/analysis/budgets.py``.  A program declares how many
of each seam collective (``"exchange"``, ``"gather"``) one call may make,
and the check compares the seam's counts of the call
(:mod:`.seam`) with it, by the reference's three tests:

* ``exact``: the collective appears exactly N times (the two-phase wave
  contract: request + reply = 2 exchanges),
* ``max``: it appears at most N times,
* anything else counted must be absent (undeclared).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .report import Violation


@dataclass(frozen=True)
class CollectiveBudget:
    """Declared collective budget for one program call."""
    exact: Dict[str, int] = field(default_factory=dict)
    max: Dict[str, int] = field(default_factory=dict)

    def merged_keys(self):
        return set(self.exact) | set(self.max)


def check_budget(program_name: str, counts: Dict[str, int],
                 budget: CollectiveBudget) -> List[Violation]:
    """``counts``: the seam's counts of one call (``collective_counts(
    ...).counts``)."""
    out: List[Violation] = []
    for kind, want in budget.exact.items():
        got = counts.get(kind, 0)
        if got != want:
            out.append(Violation(
                "collective_budget", program_name,
                f"{kind}: expected exactly {want}, the call made {got}",
                {"collective": kind, "expected": want, "got": got}))
    for kind, cap in budget.max.items():
        got = counts.get(kind, 0)
        if got > cap:
            out.append(Violation(
                "collective_budget", program_name,
                f"{kind}: budget allows at most {cap}, the call made {got}",
                {"collective": kind, "max": cap, "got": got}))
    for kind, got in sorted(counts.items()):
        if got and kind not in budget.merged_keys():
            out.append(Violation(
                "collective_budget", program_name,
                f"{kind}: {got} undeclared collective(s) — extend the "
                f"budget or remove the call",
                {"collective": kind, "got": got}))
    return out
