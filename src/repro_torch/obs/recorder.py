"""The flight recorder: a bounded host-side ring of wave summaries.

Copy of ``repro/obs/recorder.py``.  When a wave overflows, the
recorder's trajectory (the last K wave summaries) is attached to the
raised :class:`~repro_torch.dqueue.errors.QueueOverflowError`.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional


class FlightRecorder:
    """Keep the last ``k`` wave-summary dicts."""

    def __init__(self, k: int = 16):
        if k < 1:
            raise ValueError("flight recorder needs k >= 1")
        self.k = k
        self._ring: deque = deque(maxlen=k)

    def record(self, summary: dict) -> None:
        self._ring.append(dict(summary))

    def extend(self, summaries: Iterable[dict]) -> None:
        for s in summaries:
            self.record(s)

    def trajectory(self) -> list:
        """Oldest-first copy of the recorded summaries."""
        return [dict(s) for s in self._ring]

    def last(self) -> Optional[dict]:
        return dict(self._ring[-1]) if self._ring else None

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)
