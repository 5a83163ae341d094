"""The SKUEUE aggregation tree as a prefix scan: FIFO, LIFO, P tiers, Seap.

Counterpart of ``repro/core/scan_queue.py``.  A request acts on the anchor
state (f, l) = (first, last) as

    ENQ:  f' = f,                 l' = l + 1
    DEQ:  f' = min(f + 1, l + 1), l' = l

and every composition stays in the family T(A, B, C): f' = min(f + A,
l + B), l' = l + C, with identity (0, INF, 0) and the composition
T1 ; T2 = (A1 + A2, min(B1 + A2, C1 + B2, INF), C1 + C2).  The composition
is associative but not commutative: every combine takes (earlier, later).
Given the exclusive prefix state (f_i, l_i) of request i, an ENQ gets
position l_i + 1 and a DEQ gets f_i if f_i <= l_i, else ⊥ = -1.

:func:`queue_scan` is the plain version of the segscan kernel
(``repro_torch.kernels.segscan``).  On one device the reference's
``sharded_queue_scan`` (per-shard scan, then a hypercube scan of the shard
carries) is this flat scan over the shard-major wave array, which holds the
reference's global order.

The stack (paper Sec. VI) is the max-plus analogue on (last, ticket):
PUSH l' = l + 1, t' = t + 1; POP l' = max(l - 1, 0), t' = t; the family
l' = max(l + a, b) composes as (a1 + a2, max(b1 + a2, b2, -INF)).  A PUSH
gets (position l_i + 1, ticket t_i + 1), a POP (position l_i, bound t_i)
if l_i >= 1, else ⊥.  :func:`stack_scan` is the plain version of the
stack-scan kernel.  :func:`priority_queue_scan` runs P of these FIFO
windows, one per tier, and resolves a wave's dequeues highest tier first.
:func:`seap_queue_scan` runs one window per bucket of Seap's key
directory, looked up by :func:`seap_bucket_lookup`, and rebalances the
directory in the wave.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.backend import resolve_device
from ..kernels.relaxed import relaxed_deletemin
from .seap import INT32_MAX, INT32_MIN

INF = 2 ** 30   # +infinity of the tropical semiring; A, C >= 0 keep sums
#                 below 2^31 for any wave shorter than 2^30 ops
BOTTOM = -1


class QueueState(NamedTuple):
    """Anchor state: occupied positions are [first, last] (0-d int32)."""
    first: torch.Tensor
    last: torch.Tensor

    @staticmethod
    def empty(device=None) -> "QueueState":
        """The empty queue, (first, last) = (0, -1), on ``device`` (CUDA
        when None; raises where there is none)."""
        device = resolve_device(device)
        return QueueState(torch.tensor(0, dtype=torch.int32, device=device),
                          torch.tensor(-1, dtype=torch.int32, device=device))

    @property
    def size(self) -> torch.Tensor:
        """Live element count, ``last - first + 1``."""
        return self.last - self.first + 1


class StackState(NamedTuple):
    """Stack anchor state: ``last`` is the top (positions start at 1),
    ``ticket`` the monotone push counter (0-d int32)."""
    last: torch.Tensor
    ticket: torch.Tensor

    @staticmethod
    def empty(device=None) -> "StackState":
        """The empty stack, (last, ticket) = (0, 0), on ``device`` (CUDA
        when None; raises where there is none)."""
        device = resolve_device(device)
        return StackState(torch.tensor(0, dtype=torch.int32, device=device),
                          torch.tensor(0, dtype=torch.int32, device=device))


def queue_op_transforms(is_enq: torch.Tensor):
    """Per-request (A, B, C) int32 transforms; is_enq: bool or int."""
    e = is_enq.to(torch.int32)
    A = 1 - e                                    # ENQ: 0, DEQ: 1
    B = torch.where(e > 0, INF, 1).to(torch.int32)   # ENQ: INF, DEQ: 1
    C = e                                        # ENQ: 1, DEQ: 0
    return A, B, C


def queue_compose(t1, t2):
    """(t1 then t2), elementwise.  Not commutative: t1 is the earlier."""
    A1, B1, C1 = t1
    A2, B2, C2 = t2
    return (A1 + A2,
            torch.clamp_max(torch.minimum(B1 + A2, C1 + B2), INF),
            C1 + C2)


def _inclusive_scan(tr, compose=queue_compose):
    """Hillis-Steele inclusive scan of (A, B, C) along the last dim:
    log2(n) rounds, each composing element i - shift (earlier) with i."""
    A, B, C = tr
    n = A.shape[-1]
    shift = 1
    while shift < n:
        nA, nB, nC = compose(
            (A[..., :-shift], B[..., :-shift], C[..., :-shift]),
            (A[..., shift:], B[..., shift:], C[..., shift:]))
        A = torch.cat([A[..., :shift], nA], -1)
        B = torch.cat([B[..., :shift], nB], -1)
        C = torch.cat([C[..., :shift], nC], -1)
        shift *= 2
    return A, B, C


def _exclusive(inc, fills=(0, INF, 0)):
    """Inclusive results -> exclusive (shift right, identity first)."""
    return tuple(torch.cat([torch.full_like(x[..., :1], f), x[..., :-1]], -1)
                 for x, f in zip(inc, fills))


def queue_scan(is_enq: torch.Tensor, state: QueueState,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, QueueState]:
    """Assign positions to a flat request batch (global order = array order).

    Args:
      is_enq: [n] bool, True for ENQUEUE.
      state: the incoming anchor state (0-d int32 tensors).
      valid: [n] bool padding mask; False entries are identity transforms.
    Returns:
      positions [n] int32 (⊥ = -1), matched [n] bool, the new state.
    """
    if valid is not None:
        A, B, C = queue_op_transforms(is_enq & valid)
        tr = (torch.where(valid, A, 0), torch.where(valid, B, INF),
              torch.where(valid, C, 0))
        tr = tuple(x.to(torch.int32) for x in tr)
    else:
        tr = queue_op_transforms(is_enq)
    if is_enq.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=is_enq.device),
                torch.empty(0, dtype=torch.bool, device=is_enq.device), state)
    inc = _inclusive_scan(tr)
    Ax, Bx, Cx = _exclusive(inc)
    f_i = torch.minimum(state.first + Ax, state.last + Bx)
    l_i = state.last + Cx
    pos = torch.where(is_enq, l_i + 1,
                      torch.where(f_i <= l_i, f_i, BOTTOM)).to(torch.int32)
    matched = pos != BOTTOM
    if valid is not None:
        pos = torch.where(valid, pos, BOTTOM).to(torch.int32)
        matched = matched & valid
    A_t, B_t, C_t = (x[-1] for x in inc)
    new = QueueState(torch.minimum(state.first + A_t, state.last + B_t),
                     state.last + C_t)
    return pos, matched, new


# ------------------------------------------------------------ stack scan ---
def stack_op_transforms(is_push: torch.Tensor):
    """Per-request (a, b, dt) int32 transforms; is_push: bool or int."""
    p = is_push.to(torch.int32)
    a = 2 * p - 1                                    # PUSH: +1, POP: -1
    b = torch.where(p > 0, -INF, 0).to(torch.int32)  # POP clamps at 0
    return a, b, p                                   # dt: ticket increment


def stack_compose(t1, t2):
    """(t1 then t2), elementwise.  Not commutative: t1 is the earlier.
    The clamp at -INF keeps every b of a push run (garbage that never wins
    a max against ``last + a``) inside int32 whatever the bracketing."""
    a1, b1, d1 = t1
    a2, b2, d2 = t2
    return (a1 + a2,
            torch.clamp_min(torch.maximum(b1 + a2, b2), -INF),
            d1 + d2)


def stack_scan(is_push: torch.Tensor, state: StackState,
               valid: Optional[torch.Tensor] = None):
    """Max-plus LIFO position assignment over a flat request batch.

    Returns (positions [n] int32 with ⊥ = -1, tickets [n] int32, matched
    [n] bool, the new state).  For a push the ticket is the element's
    unique ticket, for a pop the bound: it takes the largest live ticket
    at its slot that is not above it.  Like the reference, ``tick`` is
    not masked by ``valid``.
    """
    tr = stack_op_transforms(is_push if valid is None else is_push & valid)
    if valid is not None:
        a, b, d = tr
        tr = tuple(torch.where(valid, x, f).to(torch.int32)
                   for x, f in ((a, 0), (b, -INF), (d, 0)))
    if is_push.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=is_push.device)
        return empty, empty.clone(), empty.bool(), state
    inc = _inclusive_scan(tr, stack_compose)
    a_x, b_x, d_x = _exclusive(inc, fills=(0, -INF, 0))
    l_i = torch.maximum(state.last + a_x, b_x)
    t_i = state.ticket + d_x
    pos = torch.where(is_push, l_i + 1,
                      torch.where(l_i >= 1, l_i, BOTTOM)).to(torch.int32)
    tick = torch.where(is_push, t_i + 1, t_i).to(torch.int32)
    matched = pos != BOTTOM
    if valid is not None:
        pos = torch.where(valid, pos, BOTTOM).to(torch.int32)
        matched = matched & valid
    a_t, b_t, d_t = (x[-1] for x in inc)
    new = StackState(torch.maximum(state.last + a_t, b_t).to(torch.int32),
                     (state.ticket + d_t).to(torch.int32))
    return pos, tick, matched, new


# -------------------------------------------------- priority-tier scan -----
def strict_batch_deletemin(deq: torch.Tensor, avail: torch.Tensor,
                           firsts: torch.Tensor, n_prios: int):
    """Skeap's strict batch-DeleteMin as prefix arithmetic: the d-th
    dequeue of the wave takes the d-th element of the priority-ordered
    pool, with no sequential loop.

    deq: [n] bool (global wave order); avail: [P] int32, tier sizes after
    the wave's enqueues; firsts: [P] int32 heads.  Returns (tier [n] int32
    clamped to [0, P), pos [n] int32, matched [n] bool, taken [P] int32).
    """
    d_in = deq.to(torch.int32)
    d_rank = (torch.cumsum(d_in, 0) - d_in).to(torch.int32)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=deq.device),
                     torch.cumsum(avail.to(torch.int32), 0).to(torch.int32)])
    t_d = (d_rank[:, None] >= cum[None, 1:]).sum(1).to(torch.int32)
    matched = deq & (t_d < n_prios)
    t_c = torch.clamp_max(t_d, n_prios - 1).long()
    pos = (firsts[t_c] + d_rank - cum[t_c]).to(torch.int32)
    taken = torch.minimum(torch.clamp_min(d_in.sum() - cum[:-1], 0), avail)
    return t_c.to(torch.int32), pos, matched, taken.to(torch.int32)


def priority_queue_scan(is_enq: torch.Tensor, prio: torch.Tensor,
                        valid: torch.Tensor, firsts: torch.Tensor,
                        lasts: torch.Tensor, *, n_prios: int,
                        relaxation: int = 0,
                        shard_of: Optional[torch.Tensor] = None,
                        n_shards: Optional[int] = None, tier_scan=None):
    """Batch position assignment for the P-tier constant-priority queue.

    P independent FIFO windows ``[firsts[p], lasts[p]]``, one per tier.  A
    wave applies its enqueues first (per-tier FIFO positions), then its
    dequeues highest tier first: strict mode (``relaxation=0``) is prefix
    arithmetic (:func:`strict_batch_deletemin`); ``relaxation=k`` lets a
    dequeue take a locally owned head up to k tiers below the best one,
    a sequential walk over the wave's dequeues
    (:func:`~repro_torch.kernels.relaxed.relaxed_deletemin`: one kernel
    launch on CUDA, no host read).

    Args:
      is_enq/valid: [n] bool; prio: [n] int32 (ignored for dequeues; an
        enqueue outside [0, n_prios) gets no position but stays matched,
        as in the reference); firsts/lasts: [P] int32.
      shard_of/n_shards: issuing shard per op and shard count, needed when
        ``relaxation > 0``.
      tier_scan: ``(enq, tier, firsts, lasts) -> (pos, new_lasts)``, the
        fused per-tier enqueue sweep (``kernels.segscan.make_tier_scan``);
        None runs one masked :func:`queue_scan` per tier, the oracle.
    Returns:
      (tier [n] int32 (-1 unmatched), pos [n] int32 (⊥ = -1), matched [n]
      bool, new_firsts, new_lasts, n_relaxed (0-d int32)).
    """
    enq = is_enq & valid
    deq = ~is_enq & valid
    dev = is_enq.device
    prio = prio.to(torch.int32)
    tier = torch.full(is_enq.shape, -1, dtype=torch.int32, device=dev)
    pos = torch.full(is_enq.shape, BOTTOM, dtype=torch.int32, device=dev)
    if tier_scan is not None:
        pos_e, new_lasts = tier_scan(enq, prio, firsts, lasts)
        tier = torch.where(enq & (pos_e >= 0), prio, tier)
        pos = torch.where(enq, pos_e, pos)
    else:
        new_lasts = []
        for p in range(n_prios):
            mask = enq & (prio == p)
            pos_p, _, st_p = queue_scan(mask, QueueState(firsts[p], lasts[p]),
                                        valid=mask)
            tier = torch.where(mask, p, tier)
            pos = torch.where(mask, pos_p, pos)
            new_lasts.append(st_p.last)
        new_lasts = torch.stack(new_lasts).to(torch.int32)
    avail = (new_lasts - firsts + 1).to(torch.int32)
    if relaxation == 0:
        t_c, pos_d, d_matched, taken = strict_batch_deletemin(
            deq, avail, firsts, n_prios)
        n_relaxed = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        if shard_of is None or n_shards is None:
            raise ValueError("relaxation > 0 needs shard_of and n_shards")
        t_c, pos_d, d_matched, taken, n_relaxed = relaxed_deletemin(
            deq, shard_of, avail, firsts, n_prios, relaxation, n_shards)
    tier = torch.where(d_matched, t_c, tier).to(torch.int32)
    pos = torch.where(d_matched, pos_d, pos).to(torch.int32)
    return (tier, pos, enq | d_matched, (firsts + taken).to(torch.int32),
            new_lasts.to(torch.int32), n_relaxed)


# -------------------------------------------------- seap bucket scan -------
def seap_bucket_lookup(key: torch.Tensor, lo: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """Predecessor lookup in the bucket directory: for each key, the
    active bucket with the largest boundary ``lo <= key``.

    The root bucket (id 0) keeps ``lo == INT32_MIN`` and is always active,
    so every key has a home; active boundaries are distinct by the split
    rule, so the argmax is unique (ties at ``INT32_MIN`` go to the root:
    ``torch.argmax`` returns the first index, as ``jnp.argmax`` does).
    The lookup is an ``[n, B]`` broadcast: 2 MB of int32 at n = 65,536
    and B = 8, but 268 MB at B = 1,024.

    key: [n] int32 (a wider integer type is cast); lo: [B] int32;
    active: [B] bool.  Returns [n] int32 bucket ids.
    """
    key = key.to(torch.int32)
    eligible = active[None, :] & (lo[None, :] <= key[:, None])
    score = torch.where(eligible, lo[None, :], INT32_MIN)
    return torch.argmax(score, dim=1).to(torch.int32)


def seap_queue_scan(is_enq: torch.Tensor, key: torch.Tensor,
                    valid: torch.Tensor, firsts: torch.Tensor,
                    lasts: torch.Tensor, lo: torch.Tensor,
                    active: torch.Tensor, key_lo: torch.Tensor,
                    key_hi: torch.Tensor, *, n_buckets: int,
                    split_occupancy: int, tier_scan=None):
    """Batch position assignment for the arbitrary-key Seap queue (Seap's
    search structure collapsed to a two-level bucket directory).

    One wave applies all enqueues before all dequeues, then rebalances:

      * enqueues: the bucket from :func:`seap_bucket_lookup`, then
        per-bucket FIFO positions (the priority scan's machinery with
        tier := bucket);
      * dequeues: :func:`strict_batch_deletemin` over the directory
        sorted by boundary, FIFO inside each bucket;
      * rebalance: at most one split a wave (the fullest bucket above
        ``split_occupancy`` is halved into the lowest free id, at the
        floor midpoint of its range clamped to the observed key range),
        preceded by at most one on-demand merge (the lowest-id active
        empty non-root bucket is recycled when the split wants an id and
        none is free).  Plain tensor arithmetic with no host read, so a
        pipelined burst stays free of host synchronisation.

    Args:
      is_enq/valid: [n] bool (global wave order); key: [n] int32 (ignored
        for dequeues; a wider integer type is cast, wrapping as int32
        does); firsts/lasts/lo: [B] int32; active: [B] bool;
        key_lo/key_hi: 0-d int32, the least and greatest key ever
        enqueued (INT32_MAX/INT32_MIN while none was).
      tier_scan: ``(enq, tier, firsts, lasts) -> (pos, new_lasts)``, the
        fused per-tier enqueue sweep (``kernels.segscan.make_tier_scan``);
        None runs one masked :func:`queue_scan` per bucket, the oracle.
    Returns:
      (bucket [n] int32 (-1 unmatched), pos [n] int32 (⊥ = -1), matched
      [n] bool, new_firsts, new_lasts, new_lo, new_active, new_key_lo,
      new_key_hi, n_active (0-d int32, the directory size after the
      rebalance)).
    """
    B = n_buckets
    dev = is_enq.device
    key = key.to(torch.int32)
    enq = is_enq & valid
    deq = ~is_enq & valid
    bucket_e = seap_bucket_lookup(key, lo, active)
    bucket = torch.full(is_enq.shape, -1, dtype=torch.int32, device=dev)
    pos = torch.full(is_enq.shape, BOTTOM, dtype=torch.int32, device=dev)
    if tier_scan is not None:
        pos_e, new_lasts = tier_scan(enq, bucket_e, firsts, lasts)
        bucket = torch.where(enq & (pos_e >= 0), bucket_e, bucket)
        pos = torch.where(enq, pos_e, pos)
    else:
        new_lasts = []
        for b in range(B):
            mask = enq & (bucket_e == b)
            pos_b, _, st_b = queue_scan(mask, QueueState(firsts[b], lasts[b]),
                                        valid=mask)
            bucket = torch.where(mask, b, bucket)
            pos = torch.where(mask, pos_b, pos)
            new_lasts.append(st_b.last)
        new_lasts = torch.stack(new_lasts)
    avail = new_lasts - firsts + 1               # sizes after enqueues

    # dequeues: batch-DeleteMin over the directory in boundary order
    # (inactive buckets sort last and are empty, so none is taken; the
    # sort is stable, as jnp.argsort, for the ties at INT32_MAX)
    order = torch.argsort(torch.where(active, lo, INT32_MAX), stable=True)
    t_s, pos_d, d_matched, taken_s = strict_batch_deletemin(
        deq, avail[order], firsts[order], B)
    taken = torch.empty_like(taken_s)
    taken[order] = taken_s
    bucket = torch.where(d_matched, order[t_s.long()].to(torch.int32),
                         bucket)
    pos = torch.where(d_matched, pos_d, pos)
    matched = enq | d_matched
    new_firsts = firsts + taken

    # the running observed key range (enqueued keys only)
    new_key_lo = torch.minimum(key_lo, torch.where(enq, key, INT32_MAX).min())
    new_key_hi = torch.maximum(key_hi, torch.where(enq, key, INT32_MIN).max())

    # rebalance: merge on demand, then split
    sizes = new_lasts - new_firsts + 1
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    occ = torch.where(active, sizes, -1)
    over = occ > split_occupancy
    cand = active & (sizes == 0) & (lo != INT32_MIN)
    need = over.any() & ~(~active).any()         # want to split, no free id
    active = torch.where(
        (ids == torch.argmax(cand.to(torch.int32))) & need & cand.any(),
        False, active)
    free = ~active
    b_s = torch.argmax(torch.where(over, occ, -1))  # fullest; ties: lowest
    lo_s = lo.index_select(0, b_s.view(1))           # [1]: no host read
    hi = torch.where(active & (lo > lo_s), lo, INT32_MAX).min()
    # clamp the halving to the observed key range, saturating the +/-1 at
    # the int32 edges (every operand int32: the -1 and +1 wrap in the arm
    # that is not taken, as in the reference)
    lo_eff = torch.maximum(lo_s, torch.where(new_key_lo == INT32_MIN,
                                             INT32_MIN, new_key_lo - 1))
    hi_eff = torch.minimum(hi, torch.where(new_key_hi == INT32_MAX,
                                           INT32_MAX, new_key_hi + 1))
    # floor((lo_eff + hi_eff) / 2) without leaving int32
    mid = (lo_eff & hi_eff) + ((lo_eff ^ hi_eff) >> 1)
    do_split = over.any() & free.any() & (mid > lo_s) & (mid < hi)
    at_free = (ids == torch.argmax(free.to(torch.int32))) & do_split
    new_lo = torch.where(at_free, mid, lo)
    new_active = active | at_free
    n_active = new_active.sum(dtype=torch.int32)
    return (bucket, pos, matched, new_firsts, new_lasts, new_lo, new_active,
            new_key_lo, new_key_hi, n_active)
