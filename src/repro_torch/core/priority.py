"""Host-side P-tier priority-queue oracle (Skeap's constant-priority regime).

Counterpart of ``repro/core/priority.py``: the same plain Python.

The reference the device implementation is differentially tested against:
P independent SKUEUE position intervals — one ``[first_p, last_p]`` dense
window plus a position-keyed element store per tier — tie-broken by tier.
Wave semantics match ``repro_torch.core.scan_queue.priority_queue_scan``
exactly (and
are implemented independently of it, in plain Python over dicts, so the two
can disagree):

* all of a wave's enqueues apply before its dequeues (the FIFO
  wave's PUT-before-GET rule lifted to tiers);
* the wave's dequeues drain the priority-ordered pool highest tier first,
  in wave order — the d-th dequeue gets the d-th best element (exactly the
  Skeap batch-DeleteMin assignment);
* with ``relaxation=k`` a dequeue issued at shard ``s`` may take the head
  of a tier up to ``k`` below the currently-best non-empty tier when that
  lower head is local (``head % n_shards == s``) and no better candidate
  head is — per-tier FIFO is never violated and the tier skew is bounded
  by k (arXiv:2503.02164's bounded-relaxation idea, specialized to tiers).

Sequential consistency across waves is by construction: each wave's
linearization is (enqueues in wave order, then dequeues in wave order),
and waves append to one total order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

BOTTOM = -1
ENQ, DEQ = "enq", "deq"


@dataclass
class OpRecord:
    """Per-op oracle verdict: tier/pos are -1 for unmatched dequeues."""
    tier: int
    pos: int
    matched: bool
    value: Optional[int] = None   # dequeues only: the element taken
    relaxed: bool = False         # served from below the strictly-best tier


class PriorityOracle:
    """Sequentially consistent P-tier priority queue over integer elements.

    ``wave(ops, n_shards=...)`` consumes one wave of operations —
    ``(kind, prio, elem, shard)`` tuples (or None for padding) in global
    wave order — and returns one :class:`OpRecord` per op.
    """

    def __init__(self, n_prios: int, relaxation: int = 0):
        if n_prios < 1:
            raise ValueError("need at least one priority tier")
        self.P = n_prios
        self.k = relaxation
        self.firsts = [0] * n_prios
        self.lasts = [-1] * n_prios
        self.store: List[dict] = [dict() for _ in range(n_prios)]

    # ------------------------------------------------------------ queries --
    @property
    def sizes(self) -> List[int]:
        return [l - f + 1 for f, l in zip(self.firsts, self.lasts)]

    @property
    def size(self) -> int:
        return sum(self.sizes)

    # ------------------------------------------------------------- waves ---
    def wave(self, ops: Sequence[Optional[Tuple]], n_shards: int = 1
             ) -> List[OpRecord]:
        recs: List[Optional[OpRecord]] = [None] * len(ops)
        # ---- enqueues first (per-tier FIFO append) ----
        for i, op in enumerate(ops):
            if op is None:
                recs[i] = OpRecord(-1, BOTTOM, False)
                continue
            kind, prio, elem, _shard = op
            if kind == ENQ:
                if not 0 <= prio < self.P:
                    raise ValueError(f"priority {prio} outside [0, {self.P})")
                self.lasts[prio] += 1
                self.store[prio][self.lasts[prio]] = elem
                recs[i] = OpRecord(prio, self.lasts[prio], True)
        # ---- dequeues drain highest-priority-first, in wave order ----
        taken = [0] * self.P
        for i, op in enumerate(ops):
            if op is None or op[0] != DEQ:
                continue
            shard = op[3]
            sizes = [self.lasts[p] - self.firsts[p] + 1 - taken[p]
                     for p in range(self.P)]
            nonempty = [p for p in range(self.P) if sizes[p] > 0]
            if not nonempty:
                recs[i] = OpRecord(-1, BOTTOM, False)
                continue
            pstar = nonempty[0]
            q = pstar
            if self.k > 0:
                for cand in range(pstar, min(pstar + self.k, self.P - 1) + 1):
                    if (sizes[cand] > 0 and
                            (self.firsts[cand] + taken[cand]) % n_shards
                            == shard):
                        q = cand
                        break
            pos = self.firsts[q] + taken[q]
            taken[q] += 1
            recs[i] = OpRecord(q, pos, True, value=self.store[q].pop(pos),
                               relaxed=(q != pstar))
        for p in range(self.P):
            self.firsts[p] += taken[p]
        return recs
