"""Plain PyTorch model of the distributed FIFO queue's answers.

The queue is one sequence of positions.  Ops are applied one at a time in
the wave's flat order (shard-major: shard 0's ops first), and waves in
the order they were issued, so a burst of K waves is one sequence of
``K * n`` ops.  An enqueue takes the next position after the last; a
dequeue takes the oldest live position, or is ⊥ exactly when the queue is
empty at its turn.  The element at a position is the id its enqueue
carried.  Membership changes (JOIN, LEAVE) move elements between shards
but leave positions, order and contents as they were, so the model only
changes the capacity it is given.

The model runs wherever its inputs are (the CPU in the tests, the card
after a run's window), in plain tensor operations: prefix sums and
gathers.  Positions are int64 here and are wrapped to int32 where they
are compared, as the program keeps them.
"""
from __future__ import annotations

import torch


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (int64) wrapped to int32, as an int32 sum wraps."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(
        torch.int32)


def ring_size(max_live: int, max_burst: int) -> int:
    """A power of two above every live position of a window plus a
    burst's enqueues, so that no write of a burst lands on a position a
    dequeue of the same burst still reads."""
    need = 2 * (max_live + max_burst)
    return 1 << max(1, (need - 1).bit_length())


class FifoModel:
    """The queue's state as ``[first, last]`` and the ids at live
    positions (a ring indexed by position)."""

    def __init__(self, max_live: int, max_burst: int, device):
        self.first, self.last = 0, -1
        r = ring_size(max_live, max_burst)
        self.ring = torch.full((r,), -1, dtype=torch.int64, device=device)
        self.mask = r - 1

    @property
    def size(self) -> int:
        """Live elements."""
        return self.last - self.first + 1

    def burst(self, is_enq: torch.Tensor, valid: torch.Tensor,
              ids: torch.Tensor, capacity: int, answers: bool = True) -> dict:
        """Apply ``K`` waves.  ``is_enq``/``valid``: ``[K, n]`` bool;
        ``ids``: ``[K, n]`` int64; ``capacity``: elements the window holds.

        Returns ``overflow`` ``[K]`` (a wave's enqueues would not fit on
        top of the queue as the wave found it) and, with ``answers``,
        ``[K, n]`` tensors: ``pos`` (int32, ⊥ and invalid -1),
        ``matched``, ``deq_ok`` (a dequeue that got an element) and
        ``deq_ids`` (int64, -1 where ``deq_ok`` is False)."""
        K, n = is_enq.shape
        dev = is_enq.device
        e = (is_enq & valid).reshape(-1)
        d = (~is_enq & valid).reshape(-1)
        if int(d.sum()) <= self.size:       # the queue cannot run empty
            ok = d
        else:
            walk = self.size + torch.cumsum(e.long() - d.long(), 0)
            floor = torch.cummax(torch.clamp_min(-walk, 0), 0).values
            prev = torch.cat([floor.new_zeros(1), floor[:-1]])
            ok = d & ~(floor > prev)        # ⊥ exactly on an empty queue
        n_enq, n_ok = int(e.sum()), int(ok.sum())
        enq_pos = self.last + 1 + torch.arange(n_enq, device=dev)
        self.ring[enq_pos & self.mask] = ids.reshape(-1)[e]
        ok_w = ok.view(K, n).sum(1)
        first_w = self.first + torch.cumsum(ok_w, 0) - ok_w
        last_w = self.last + torch.cumsum(e.view(K, n).sum(1), 0)
        out = {"overflow": last_w - first_w + 1 > capacity}
        if answers:
            deq_pos = self.first + torch.arange(n_ok, device=dev)
            pos = torch.full((K * n,), -1, dtype=torch.int64, device=dev)
            pos[e] = enq_pos
            pos[ok] = deq_pos
            deq_ids = torch.full_like(pos, -1)
            deq_ids[ok] = self.ring[deq_pos & self.mask]
            out.update(pos=wrap32(pos).view(K, n), matched=(e | ok).view(K, n),
                       deq_ok=ok.view(K, n), deq_ids=deq_ids.view(K, n))
        self.first += n_ok
        self.last += n_enq
        return out
