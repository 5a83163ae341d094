"""Plain PyTorch and NumPy model of the P-tier priority queue's answers
(Skeap with a constant set of priorities, arXiv:1805.03472), strict or
relaxed.

Each tier is a FIFO sequence of positions.  A wave applies all of its
enqueues first, each at the next position of its tier in the wave's flat
order (shard-major), and then its dequeues in that order:

* strict (``relaxation == 0``): the d-th dequeue of the wave takes the
  d-th element of the pool ordered by tier, then position;
* relaxed (``relaxation == k``): let p* be the most urgent tier that still
  holds an element.  A dequeue issued by shard s takes the head of the
  first tier c in ``[p*, p* + k]`` (capped at the last tier) that holds an
  element and whose head position h has ``h mod n_shards == s`` (floor
  modulo of h as an int32); where there is none, it takes p*'s head.

A dequeue with every tier empty is ⊥.  Enqueue positions and the ids at
positions are tensor operations where the inputs are; the dequeues'
rule is walked on the host in NumPy, in runs: the dequeues that take p*'s
head one after another are assigned at once, up to the first that stops
the run (p* runs dry, or the dequeue's shard owns the head of a tier
below p* in the window and not p*'s head).
"""
from __future__ import annotations

import numpy as np
import torch

from .fifo import ring_size, wrap32

FIRST_CHUNK = 512        # dequeues searched for a run's end at first


def _owner(h: int, n_shards: int) -> int:
    """Floor modulo of position ``h`` as an int32."""
    return ((h + (1 << 31)) % (1 << 32) - (1 << 31)) % n_shards


class PriorityModel:
    """Per-tier ``[first, last]`` windows (host ints) and the ids at live
    positions (one ring a tier, where the inputs are)."""

    def __init__(self, n_prios: int, relaxation: int, max_live: int,
                 max_burst: int, device):
        self.P = int(n_prios)
        self.k = int(relaxation)
        self.firsts = np.zeros(self.P, np.int64)
        self.lasts = np.full(self.P, -1, np.int64)
        r = ring_size(max_live, max_burst)
        self.ring = torch.full((self.P * r,), -1, dtype=torch.int64,
                               device=device)           # tier t at t * r
        self.r, self.mask = r, r - 1

    @property
    def sizes(self) -> list:
        """Live elements of each tier."""
        return [int(x) for x in self.lasts - self.firsts + 1]

    @property
    def size(self) -> int:
        """Live elements over every tier."""
        return sum(self.sizes)

    def burst(self, is_enq: torch.Tensor, valid: torch.Tensor,
              prio: torch.Tensor, ids: torch.Tensor, n_shards: int,
              capacity: int, answers: bool = True) -> dict:
        """Apply ``K`` waves of ``n = n_shards * L`` ops each (``[K, n]``
        tensors).  ``capacity``: elements one tier's window holds.

        Returns ``overflow`` and ``n_relaxed`` (``[K]``) and, with
        ``answers``, ``[K, n]`` tensors: ``tier`` and ``pos`` (int32, -1
        where unmatched), ``matched``, ``deq_ok`` and ``deq_ids`` (-1
        where ``deq_ok`` is False)."""
        K, n = is_enq.shape
        P, dev = self.P, is_enq.device
        e = (is_enq & valid).reshape(-1)
        d = (~is_enq & valid).reshape(-1)
        eidx = torch.nonzero(e).squeeze(1)
        et = prio.reshape(-1)[eidx].long()
        if et.numel() and (int(et.min()) < 0 or int(et.max()) >= P):
            raise ValueError("an enqueue's tier lies outside [0, P)")
        # a tier's enqueues take its next positions in the burst's order
        st, order = torch.sort(et, stable=True)
        counts = torch.bincount(et, minlength=P)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(et)
        rank[order] = torch.arange(et.numel(), device=dev) - start[st]
        lasts = torch.from_numpy(self.lasts).to(dev)
        epos = lasts[et] + 1 + rank
        self.ring[et * self.r + (epos & self.mask)] = ids.reshape(-1)[eidx]
        per_wave = torch.bincount(eidx // n * P + et, minlength=K * P)
        lasts_w = self.lasts + np.cumsum(
            per_wave.view(K, P).cpu().numpy(), 0)
        didx = torch.nonzero(d).squeeze(1)
        dh = didx.cpu().numpy()
        bounds = np.searchsorted(dh, np.arange(K + 1) * n)
        t_d = np.full(dh.size, -1, np.int64)
        p_d = np.full(dh.size, -1, np.int64)
        overflow = np.zeros(K, bool)
        n_relaxed = np.zeros(K, np.int64)
        for w in range(K):
            avail = lasts_w[w] - self.firsts + 1
            overflow[w] = bool(np.any(avail > capacity))
            lo, hi = bounds[w], bounds[w + 1]
            if self.k == 0:
                t, p, taken = self._strict(hi - lo, avail)
            else:
                shard = (dh[lo:hi] - w * n) // (n // n_shards)
                t, p, taken, n_relaxed[w] = self._relaxed(shard, avail,
                                                          n_shards)
            t_d[lo:hi], p_d[lo:hi] = t, p
            self.firsts += taken
        self.lasts = lasts_w[-1].copy()
        out = {"overflow": torch.from_numpy(overflow),
               "n_relaxed": torch.from_numpy(n_relaxed)}
        if answers:
            tier = torch.full((K * n,), -1, dtype=torch.int64, device=dev)
            pos = torch.full_like(tier, -1)
            tier[eidx], pos[eidx] = et, epos
            tier[didx] = torch.from_numpy(t_d).to(dev)
            pos[didx] = torch.from_numpy(p_d).to(dev)
            ok = d & (tier >= 0)
            deq_ids = torch.full_like(tier, -1)
            deq_ids[ok] = self.ring[tier[ok] * self.r + (pos[ok] & self.mask)]
            out.update(tier=tier.to(torch.int32).view(K, n),
                       pos=wrap32(pos).view(K, n),
                       matched=(e | ok).view(K, n), deq_ok=ok.view(K, n),
                       deq_ids=deq_ids.view(K, n))
        return out

    def _strict(self, n_deq: int, avail: np.ndarray):
        """The d-th dequeue takes the d-th element by (tier, position)."""
        rank = np.arange(n_deq, dtype=np.int64)
        cum = np.concatenate([[0], np.cumsum(avail)])
        t = np.searchsorted(cum[1:], rank, side="right")
        got = t < self.P
        tc = np.minimum(t, self.P - 1)
        tier = np.where(got, tc, -1)
        pos = np.where(got, self.firsts[tc] + rank - cum[tc], -1)
        taken = np.minimum(np.maximum(n_deq - cum[:-1], 0), avail)
        return tier, pos, taken

    def _relaxed(self, shard: np.ndarray, avail: np.ndarray, n_shards: int):
        """The relaxed rule over one wave's dequeues, run by run."""
        P, k, D = self.P, self.k, shard.size
        rem = [int(x) for x in avail]
        head = [int(x) for x in self.firsts]
        tier = np.full(D, -1, np.int64)
        pos = np.full(D, -1, np.int64)
        is_low = np.zeros(n_shards, bool)

        def next_tier(c):
            while c < P and rem[c] <= 0:
                c += 1
            return c

        ps, t, n_rel = next_tier(0), 0, 0
        while t < D and ps < P:
            hi = min(ps + k, P - 1)
            low = [_owner(head[c], n_shards) for c in range(ps + 1, hi + 1)
                   if rem[c] > 0]
            is_low[:] = False
            is_low[low] = True
            run = min(D - t, rem[ps])
            j, start, chunk = run, 0, FIRST_CHUNK
            while low and start < run:
                end = min(run, start + chunk)
                sh = shard[t + start:t + end]
                cand = is_low[sh]
                if cand.any():
                    h = head[ps] + np.arange(start, end, dtype=np.int64)
                    own = (((h + (1 << 31)) % (1 << 32)) - (1 << 31)) \
                        % n_shards
                    stop = cand & (own != sh)
                    if stop.any():
                        j = start + int(np.argmax(stop))
                        break
                start, chunk = end, 2 * chunk
            tier[t:t + j] = ps
            pos[t:t + j] = head[ps] + np.arange(j, dtype=np.int64)
            rem[ps] -= j
            head[ps] += j
            t += j
            if rem[ps] == 0:
                ps = next_tier(ps + 1)
            elif j < run:                        # a relaxed serve
                s = int(shard[t])
                q = next(c for c in range(ps + 1, hi + 1)
                         if rem[c] > 0 and _owner(head[c], n_shards) == s)
                tier[t], pos[t] = q, head[q]
                rem[q] -= 1
                head[q] += 1
                t += 1
                n_rel += 1
        return tier, pos, avail - np.array(rem, np.int64), n_rel
