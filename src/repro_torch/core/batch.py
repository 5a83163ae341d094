"""Batch algebra (paper Definition 5).

Counterpart of ``repro/core/batch.py``: the same plain Python and numpy.

A batch is a run-length encoding of an alternating sequence of ENQUEUE and
DEQUEUE requests: ``B = (op_1, ..., op_k)`` where odd 1-based indices count
enqueues and even indices count dequeues.  We store batches as python lists /
int64 numpy arrays with 0-based indexing, so ``runs[i]`` is an enqueue run
when ``i`` is even and a dequeue run when ``i`` is odd.  ``[0]`` is the empty
batch. For the stack variant batches collapse to ``(pops, pushes)``
(Theorem 20) — handled by the caller combining locally.

JOIN/LEAVE extensions (Section IV) ride along as scalar counters ``j``/``l``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

ENQ = 0  # run parity for enqueues (0-based even index)
DEQ = 1


def empty() -> List[int]:
    return [0]


def is_empty(runs: Sequence[int]) -> bool:
    return len(runs) == 0 or all(r == 0 for r in runs)


def append_op(runs: List[int], is_enq: bool) -> None:
    """Record one locally-generated request (paper Sec. III-A), in place."""
    if not runs:
        runs.append(0)
    parity = (len(runs) - 1) % 2  # parity of the last run
    want = ENQ if is_enq else DEQ
    if parity == want:
        runs[-1] += 1
    else:
        runs.append(1)


def combine(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Elementwise sum with zero padding (paper Sec. III-A)."""
    m = max(len(a), len(b))
    out = [0] * m
    for i, v in enumerate(a):
        out[i] += int(v)
    for i, v in enumerate(b):
        out[i] += int(v)
    return out if out else [0]


def combine_many(parts: Sequence[Sequence[int]]) -> List[int]:
    out: List[int] = [0]
    for p in parts:
        out = combine(out, p)
    return out


def totals(runs: Sequence[int]) -> tuple:
    """(#enqueues, #dequeues) represented by the batch."""
    e = sum(int(v) for i, v in enumerate(runs) if i % 2 == ENQ)
    d = sum(int(v) for i, v in enumerate(runs) if i % 2 == DEQ)
    return e, d


def as_array(runs: Sequence[int], width: int) -> np.ndarray:
    """Fixed-width int64 padding, for the vectorized simulator."""
    out = np.zeros(width, dtype=np.int64)
    r = np.asarray(list(runs), dtype=np.int64)
    if len(r) > width:
        raise ValueError(f"batch has {len(r)} runs > width {width}")
    out[: len(r)] = r
    return out


@dataclass
class BatchMsg:
    """A batch in flight, with join/leave counters (Sec. IV)."""

    runs: List[int] = field(default_factory=empty)
    joins: int = 0   # B.j
    leaves: int = 0  # B.l

    def combined_with(self, other: "BatchMsg") -> "BatchMsg":
        return BatchMsg(
            runs=combine(self.runs, other.runs),
            joins=self.joins + other.joins,
            leaves=self.leaves + other.leaves,
        )

    @property
    def empty(self) -> bool:
        return is_empty(self.runs) and self.joins == 0 and self.leaves == 0
