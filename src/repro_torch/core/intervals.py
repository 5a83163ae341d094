"""Stages 2+3: anchor position-interval assignment and tree decomposition.

Counterpart of ``repro/core/intervals.py``: the same plain Python.

Queue (Sec. III-D/E): the anchor keeps ``(first, last)`` with the invariant
``first <= last + 1``; the occupied positions are ``[first, last]``.  For a
combined batch ``(op_1, ..., op_k)``:

  enqueue run i: interval [last+1, last+op_i];            last += op_i
  dequeue run i: interval [first, min(first+op_i-1,last)]; first = min(first+op_i, last+1)

Decomposition hands each sub-batch (in combination order) the leading slice
of the run interval; dequeue runs clamp at y (⊥ beyond).

Stack (Sec. VI): anchor keeps ``(last, ticket)``; pushes get
``([last+1, last+op], tickets ticket+1..)``; pops take from the TOP:
``[max(1, last-op+1), last]`` served in descending position order, each pop
also carrying the ticket bound ``t' = ticket`` at assignment time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

BOTTOM = -1  # ⊥ position for unmatched dequeues / pops


@dataclass
class AnchorState:
    first: int = 0   # queue head position
    last: int = -1   # queue tail position (first > last  <=>  empty)
    ticket: int = 0  # stack only: monotone push counter

    @property
    def size(self) -> int:
        return self.last - self.first + 1


Interval = Tuple[int, int]  # inclusive [x, y]; empty iff x > y


# ----------------------------------------------------------------- queue ---
def assign_queue(state: AnchorState, runs: Sequence[int]) -> List[Interval]:
    """Stage 2 at the anchor. Mutates ``state``; returns per-run intervals."""
    out: List[Interval] = []
    for i, op in enumerate(runs):
        op = int(op)
        if i % 2 == 0:  # enqueue run
            out.append((state.last + 1, state.last + op))
            state.last += op
        else:           # dequeue run
            y = min(state.first + op - 1, state.last)
            out.append((state.first, y))
            state.first = min(state.first + op, state.last + 1)
    return out


def decompose_queue(intervals: Sequence[Interval],
                    parts: Sequence[Sequence[int]]) -> List[List[Interval]]:
    """Stage 3 at one tree node: split run intervals across sub-batches.

    ``parts`` are the memorized sub-batches in combination order (own ops
    first, then each child).  Returns per-part run-interval lists aligned
    with each part's runs.
    """
    cursors = [list(iv) for iv in intervals]  # mutable [x, y]
    out: List[List[Interval]] = []
    for part in parts:
        sub: List[Interval] = []
        for i, op in enumerate(part):
            op = int(op)
            if i >= len(cursors):
                if op:
                    raise ValueError("sub-batch longer than combined batch")
                sub.append((0, -1))
                continue
            x, y = cursors[i]
            if i % 2 == 0:  # enqueue: leading slice, never clamped
                sub.append((x, x + op - 1))
                cursors[i][0] = x + op
            else:           # dequeue: clamp at y; beyond y means ⊥
                hi = min(x + op - 1, y)
                sub.append((x, hi))
                cursors[i][0] = min(x + op, y + 1)
        out.append(sub)
    return out


def positions_queue(run_intervals: Sequence[Interval],
                    runs: Sequence[int]) -> List[int]:
    """Per-request positions for a leaf part (local op order). ⊥ = BOTTOM."""
    pos: List[int] = []
    for i, op in enumerate(runs):
        x, y = run_intervals[i]
        for j in range(int(op)):
            p = x + j
            if i % 2 == 0:
                pos.append(p)
            else:
                pos.append(p if p <= y else BOTTOM)
    return pos


# ----------------------------------------------------------------- stack ---
def assign_stack(state: AnchorState, runs: Sequence[int]) -> List[Tuple[Interval, int]]:
    """Stage 2 for the stack. Runs alternate PUSH (even) / POP (odd).

    Returns per-run ``((x, y), ticket_info)``: for pushes the tickets are
    ``ticket+1 .. ticket+op`` base-aligned with positions; for pops the
    single ticket *bound* t' (paper: remove element with max ticket <= t').
    """
    out: List[Tuple[Interval, int]] = []
    for i, op in enumerate(runs):
        op = int(op)
        if i % 2 == 0:  # push run
            out.append(((state.last + 1, state.last + op), state.ticket + 1))
            state.last += op
            state.ticket += op
        else:           # pop run: take from the top, descending
            x = max(1, state.last - op + 1) if state.last >= 1 else 1
            y = state.last
            out.append(((x, y), state.ticket))
            state.last = max(0, state.last - op)
    return out


def decompose_stack(run_info: Sequence[Tuple[Interval, int]],
                    parts: Sequence[Sequence[int]]) -> List[List[Tuple[Interval, int]]]:
    """Stage 3 for the stack. Pops consume the TOP of the interval first."""
    cursors = [[iv[0], iv[1]] for iv, _ in run_info]
    tickets = [t for _, t in run_info]
    out: List[List[Tuple[Interval, int]]] = []
    for part in parts:
        sub: List[Tuple[Interval, int]] = []
        for i, op in enumerate(part):
            op = int(op)
            if i >= len(cursors):
                sub.append(((0, -1), 0))
                continue
            x, y = cursors[i]
            if i % 2 == 0:  # push: leading slice; ticket base shifts with x
                base = tickets[i] + (x - run_info[i][0][0])
                sub.append(((x, x + op - 1), base))
                cursors[i][0] = x + op
            else:           # pop: trailing (top) slice, descending
                lo = max(x, y - op + 1)
                sub.append(((lo, y), tickets[i]))
                cursors[i][1] = max(y - op, x - 1)
        out.append(sub)
    return out


def positions_stack(run_info: Sequence[Tuple[Interval, int]],
                    runs: Sequence[int]) -> List[Tuple[int, int]]:
    """Per-request (position, ticket) for a leaf part.  For pushes ticket is
    the unique element ticket; for pops it is the bound t'.  ⊥ = BOTTOM pos."""
    out: List[Tuple[int, int]] = []
    for i, op in enumerate(runs):
        (x, y), t = run_info[i]
        if i % 2 == 0:
            for j in range(int(op)):
                out.append((x + j, t + j))
        else:
            # pops are served top-first: y, y-1, ...
            for j in range(int(op)):
                p = y - j
                out.append((p, t) if p >= x and p >= 1 else (BOTTOM, t))
    return out
