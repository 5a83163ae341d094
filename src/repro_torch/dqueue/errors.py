"""Structured errors for the device-queue path.

Copy of ``repro/dqueue/errors.py``.  The device wave cannot raise (its
overflow flag is an output tensor), so the host-side owner of the queue
state, the elastic wrapper, turns the flag into
:class:`QueueOverflowError` once per step or burst, carrying the
per-window occupancy an admission policy needs.
"""
from __future__ import annotations

from typing import Optional, Sequence


class QueueOverflowError(RuntimeError):
    """A wave's post-enqueue peak exceeded the store capacity.

    This is a DATA-LOSS signal, not flow control: by the time the flag
    reaches the host, the flagged wave has already executed and a
    wrapped-around enqueue has overwritten a live head slot, so the
    structure's contents are no longer trustworthy.

    Attributes:
      kind: the structure ("queue" / "stack" / "pqueue" / "squeue" /
        "workqueue"; "work" when a ``WorkQueue`` batch exceeds its wave).
      capacity: elements one window holds (per tier/bucket for the
        priority and Seap queues, total for FIFO, ``slots * depth`` for
        the stack; the wave's width for "work").
      occupancy: occupancy per window AFTER the step/burst completed
        (one entry for FIFO/stack; per tier for the priority queue; per
        bucket for Seap).  The flagged wave exceeded ``capacity`` at its
        post-enqueue peak (see ``wave_engine.post_enqueue_peak_overflow``)
        — in a multi-wave burst, waves after the flagged one still ran
        and may have drained the window below what this vector shows.
      wave: index of the first overflowing wave within a multi-wave
        burst, or None for a single ``step``.
      trajectory: the flight-recorder trajectory, the last K wave-summary
        dicts leading up to the failing burst.  Empty when the owner ran
        without telemetry.
    """

    def __init__(self, kind: str, capacity: int,
                 occupancy: Sequence[int], *,
                 wave: Optional[int] = None, detail: str = "",
                 trajectory: Optional[Sequence[dict]] = None):
        self.kind = kind
        self.capacity = int(capacity)
        self.occupancy = [int(x) for x in occupancy]
        self.wave = wave
        self.trajectory = [dict(t) for t in (trajectory or [])]
        msg = (f"{kind} overflow (queue contents no longer trustworthy): "
               f"post-burst occupancy {self.occupancy} against per-window "
               f"capacity {self.capacity}")
        if wave is not None:
            msg += f" (first overflowing wave {wave})"
        if detail:
            msg += f"; {detail}"
        if self.trajectory:
            ramp = [sum(t.get("occ", [])) for t in self.trajectory]
            msg += (f"; flight recorder: {len(self.trajectory)}-wave "
                    f"occupancy ramp {ramp}")
        super().__init__(msg)

    @property
    def headroom(self) -> list:
        """Free slots per window at the post-burst snapshot
        (``capacity - occupancy``; negative entries mark the windows that
        wrapped)."""
        return [self.capacity - o for o in self.occupancy]


class ServeInvariantError(RuntimeError):
    """A serving-engine internal invariant was violated (state corruption,
    not a capacity or input error).  Carries a ``context`` dict with the
    state that witnessed the violation and, where telemetry ran, the
    flight-recorder ``trajectory``."""

    def __init__(self, message: str, *,
                 trajectory: Optional[Sequence[dict]] = None, **context):
        self.context = dict(context)
        self.trajectory = [dict(t) for t in (trajectory or [])]
        if context:
            message += " [" + ", ".join(
                f"{k}={v!r}" for k, v in context.items()) + "]"
        if self.trajectory:
            message += (f" [flight recorder: last {len(self.trajectory)} "
                        f"wave summaries attached]")
        super().__init__(message)
