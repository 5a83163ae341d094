"""Seap's bucket directory: constants, seed validation and the host oracle.

Counterpart of ``repro/core/seap.py``, whose docstring states the
semantics the port implements: an active bucket serves the keys from its
boundary ``lo`` up to the next active boundary, dequeues drain buckets in
ascending boundary order (FIFO inside one), and an in-wave split/merge
rule refines the directory.  :class:`SeapOracle` is the port's copy of
the reference's host oracle: the same wave semantics in plain Python over
key-sorted bucket dicts, independent of the device code, which the port's
``DeviceSeapQueue`` is held against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

BOTTOM = -1
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
ENQ, DEQ = "enq", "deq"


def check_seed_bounds(seed_bounds, n_buckets: int) -> list:
    """Validate a warm-start boundary list for the bucket directory.

    Seeding plants boundaries over the expected key range up front, so
    the directory orders keys from the first wave instead of after the
    split rule has zoomed in.  Bounds must be strictly increasing, above
    ``INT32_MIN`` (the root's boundary), and fit in the non-root bucket
    ids.  Returns them as a list of ints; raises ``ValueError``.
    """
    seeds = [int(s) for s in (() if seed_bounds is None else seed_bounds)]
    if len(seeds) > n_buckets - 1:
        raise ValueError(f"{len(seeds)} seed bounds need at least "
                         f"{len(seeds) + 1} buckets, have {n_buckets}")
    if any(b <= a for a, b in zip(seeds, seeds[1:])):
        raise ValueError(f"seed bounds must be strictly increasing: {seeds}")
    if seeds and not INT32_MIN < seeds[0] <= INT32_MAX:
        raise ValueError(f"seed bounds must lie in (INT32_MIN, INT32_MAX]: "
                         f"{seeds}")
    return seeds


@dataclass
class SeapOpRecord:
    """Per-op oracle verdict: bucket/pos are -1 for unmatched dequeues."""
    bucket: int
    pos: int
    matched: bool
    value: Optional[int] = None   # dequeues only: the element taken
    key: Optional[int] = None     # dequeues only: the key of that element


class SeapOracle:
    """Sequentially consistent bucket-directory priority queue over int32
    keys.  ``wave(ops)`` consumes one wave of operations — ``(kind, key,
    elem)`` tuples (or None for padding) in global wave order — and returns
    one :class:`SeapOpRecord` per op.  ``split_occupancy`` must equal the
    device queue's threshold for differential runs.
    """

    def __init__(self, n_buckets: int, split_occupancy: int,
                 seed_bounds: Optional[Sequence[int]] = None):
        if n_buckets < 1:
            raise ValueError("need at least one bucket")
        self.B = n_buckets
        self.split_occupancy = split_occupancy
        self.lo = [INT32_MAX] * n_buckets
        self.lo[0] = INT32_MIN               # bucket 0 is the root
        self.active = [False] * n_buckets
        self.active[0] = True
        for i, s in enumerate(check_seed_bounds(seed_bounds, n_buckets)):
            self.lo[1 + i] = s
            self.active[1 + i] = True
        self.firsts = [0] * n_buckets
        self.lasts = [-1] * n_buckets
        self.store: List[dict] = [dict() for _ in range(n_buckets)]
        self.keys: List[dict] = [dict() for _ in range(n_buckets)]
        self.key_lo = INT32_MAX       # observed key range (empty so far)
        self.key_hi = INT32_MIN
        self.n_splits = 0
        self.n_merges = 0

    # ------------------------------------------------------------ queries --
    @property
    def sizes(self) -> List[int]:
        return [l - f + 1 for f, l in zip(self.firsts, self.lasts)]

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def directory(self) -> List[Tuple[int, int]]:
        """Active (lo, bucket_id) entries in ascending key order."""
        return sorted((self.lo[b], b)
                      for b in range(self.B) if self.active[b])

    def _bucket_of(self, key: int) -> int:
        """Predecessor lookup: active bucket with the largest lo <= key."""
        best, best_lo = 0, INT32_MIN
        for b in range(self.B):
            if self.active[b] and self.lo[b] <= key and self.lo[b] >= best_lo:
                # distinct active boundaries -> >= only ties at the root
                best, best_lo = b, self.lo[b]
        return best

    # ------------------------------------------------------------- waves ---
    def wave(self, ops: Sequence[Optional[Tuple]]) -> List[SeapOpRecord]:
        recs: List[Optional[SeapOpRecord]] = [None] * len(ops)
        # ---- enqueues first (bucket lookup + per-bucket FIFO append) ----
        for i, op in enumerate(ops):
            if op is None:
                recs[i] = SeapOpRecord(-1, BOTTOM, False)
                continue
            kind, key, elem = op
            if kind == ENQ:
                if not INT32_MIN <= key <= INT32_MAX:
                    raise ValueError(f"key {key} outside int32")
                b = self._bucket_of(key)
                self.lasts[b] += 1
                self.store[b][self.lasts[b]] = elem
                self.keys[b][self.lasts[b]] = key
                self.key_lo = min(self.key_lo, key)
                self.key_hi = max(self.key_hi, key)
                recs[i] = SeapOpRecord(b, self.lasts[b], True)
        # ---- dequeues drain buckets in boundary order, FIFO inside ----
        order = [b for _, b in self.directory()]
        taken = [0] * self.B
        for i, op in enumerate(ops):
            if op is None or op[0] != DEQ:
                continue
            b = next((q for q in order
                      if self.lasts[q] - self.firsts[q] + 1 - taken[q] > 0),
                     None)
            if b is None:
                recs[i] = SeapOpRecord(-1, BOTTOM, False)
                continue
            pos = self.firsts[b] + taken[b]
            taken[b] += 1
            recs[i] = SeapOpRecord(b, pos, True,
                                   value=self.store[b].pop(pos),
                                   key=self.keys[b].pop(pos))
        for b in range(self.B):
            self.firsts[b] += taken[b]
        self._rebalance()
        return recs

    # --------------------------------------------------------- rebalance ---
    def _rebalance(self):
        """The in-wave split/merge rule (must mirror the device exactly)."""
        sizes = self.sizes
        over = [self.active[b] and sizes[b] > self.split_occupancy
                for b in range(self.B)]
        # merge-on-demand: an empty bucket's id is recycled only when a
        # split wants an id and none is free (empty buckets are harmless
        # future structure; eager merging would dismantle the directory
        # between bursts); lowest-id candidate, at most one per wave
        if any(over) and all(self.active):
            for b in range(self.B):
                if (self.active[b] and sizes[b] == 0
                        and self.lo[b] != INT32_MIN):
                    self.active[b] = False
                    self.n_merges += 1
                    break
        # split: fullest over-threshold bucket into the lowest free id;
        # the halving is clamped to the OBSERVED key range so the zoom
        # lands among live keys instead of descending from INT32_MAX
        if any(over) and not all(self.active):
            b_s = max(range(self.B),
                      key=lambda b: (sizes[b] if over[b] else -1, -b))
            hi = min([self.lo[b] for b in range(self.B)
                      if self.active[b] and self.lo[b] > self.lo[b_s]],
                     default=INT32_MAX)
            lo_eff = max(self.lo[b_s],
                         self.key_lo - 1 if self.key_lo > INT32_MIN
                         else INT32_MIN)
            hi_eff = min(hi, self.key_hi + 1 if self.key_hi < INT32_MAX
                         else INT32_MAX)
            mid = (lo_eff + hi_eff) // 2         # floor average, no overflow
            if self.lo[b_s] < mid < hi:
                b_f = self.active.index(False)
                self.lo[b_f] = mid
                self.active[b_f] = True
                self.n_splits += 1
