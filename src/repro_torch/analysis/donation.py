"""Rule family 2: state held in place (the reference's donation).

The reference jits every wave entry with ``donate_argnums=(0,)`` and
checks that each donated leaf received an input-output alias: a dropped
donation copies the state every wave (``repro/analysis/donation.py``).
Eager torch has no donation; the port's structures promise the same
thing directly, "the store tensors are updated in place"
(``repro_torch/dqueue/wave_engine.py``, State).  So:

* after a wave program, every store tensor of the state (and, with the
  metrics ring on, the ring's ``rows``) must sit on the storage it sat
  on before (:func:`storage_ptrs`, :func:`check_donation`); the 0-d and
  ``[P]`` carry tensors and the ring's 0-d ``count`` are new tensors each
  wave and are not held (the registry names what each program holds);
* after a migration, the old store must be gone: a ``weakref`` on each
  old store tensor is dead after the call (:func:`check_released`), so
  the device holds one store and not two.
"""
from __future__ import annotations

from typing import Dict, List

from .report import Violation


def storage_ptrs(tensors: Dict[str, object]) -> Dict[str, int]:
    """``{name: untyped_storage().data_ptr()}`` of each tensor."""
    return {k: t.untyped_storage().data_ptr() for k, t in tensors.items()}


def check_donation(program_name: str, before: Dict[str, int],
                   after: Dict[str, int], expected_held: int
                   ) -> List[Violation]:
    """``before``/``after``: :func:`storage_ptrs` of the held tensors
    around one call; ``expected_held``: how many the program must hold in
    place."""
    out: List[Violation] = []
    if len(before) < expected_held:
        out.append(Violation(
            "donation", program_name,
            f"{expected_held} tensors should be held in place but only "
            f"{len(before)} were found in the state",
            {"expected": expected_held, "got": len(before)}))
    moved = sorted(k for k in before if after.get(k) != before[k])
    if moved:
        out.append(Violation(
            "donation", program_name,
            f"{len(moved)} of {len(before)} held tensors moved to a new "
            f"storage ({', '.join(moved)}) — a copy of the state every "
            f"wave",
            {"expected": expected_held, "moved": moved,
             "held": len(before) - len(moved)}))
    return out


def check_released(program_name: str, refs: Dict[str, object]
                   ) -> List[Violation]:
    """``refs``: ``{name: weakref.ref(old store tensor)}`` taken before a
    migration; each must be dead after it."""
    alive = sorted(k for k, r in refs.items() if r() is not None)
    if not alive:
        return []
    return [Violation(
        "donation", program_name,
        f"the old store is still referenced after the migration "
        f"({', '.join(alive)}) — the device holds two stores",
        {"alive": alive, "released": len(refs) - len(alive)})]
