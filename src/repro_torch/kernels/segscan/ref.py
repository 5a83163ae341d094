"""Plain PyTorch versions of the segscan kernels.

Counterpart of ``repro/kernels/segscan/ref.py``.  The FIFO and LIFO scans
delegate to the framework scans in :mod:`repro_torch.core.scan_queue`;
the tiered sweep is its own short function (a stable sort by tier gives
each enqueue its rank among earlier enqueues of the same tier), since the
reference's oracle for it, one masked FIFO scan per tier, is P scans.
"""
from __future__ import annotations

import torch

from ...core.scan_queue import (INF, QueueState, StackState, queue_compose,
                                queue_scan, stack_compose, stack_scan)
from .kernel import QUEUE_THREADS, STACK_THREADS, TIER_THREADS, TILE


def queue_scan_ref(is_enq: torch.Tensor, valid: torch.Tensor,
                   first: torch.Tensor, last: torch.Tensor):
    """Returns (positions [n] int32 with ⊥ = -1, matched [n] bool,
    new_first, new_last), the last two 0-d int32."""
    pos, matched, new = queue_scan(
        is_enq.to(torch.bool),
        QueueState(first.to(torch.int32), last.to(torch.int32)),
        valid=valid.to(torch.bool))
    return (pos, matched, new.first.to(torch.int32),
            new.last.to(torch.int32))


def stack_scan_ref(is_push: torch.Tensor, valid: torch.Tensor,
                   last: torch.Tensor, ticket: torch.Tensor):
    """Returns (positions [n] int32 with ⊥ = -1, tickets [n] int32,
    matched [n] bool, new_last, new_ticket)."""
    pos, tick, matched, new = stack_scan(
        is_push.to(torch.bool),
        StackState(last.to(torch.int32), ticket.to(torch.int32)),
        valid=valid.to(torch.bool))
    return pos, tick, matched, new.last, new.ticket


def tiered_queue_scan_ref(enq: torch.Tensor, tier: torch.Tensor,
                          lasts: torch.Tensor):
    """Per-tier enqueue positions: an enqueue of tier t in [0, P) gets
    ``lasts[t] + 1 +`` (earlier enqueues of tier t); anything else -1.
    Returns (pos [n] int32, new_lasts [P] int32)."""
    P = lasts.shape[0]
    n = enq.shape[0]
    tier = tier.to(torch.int64)
    live = enq.to(torch.bool) & (tier >= 0) & (tier < P)
    key = torch.where(live, tier, P)
    skey, order = torch.sort(key, stable=True)
    first_of_key = torch.searchsorted(skey, skey)
    rank = torch.empty_like(key).scatter_(
        0, order, torch.arange(n, device=key.device) - first_of_key)
    counts = torch.bincount(key, minlength=P + 1)[:P]
    lasts = lasts.to(torch.int64)
    pos = torch.where(live, lasts[key.clamp_max(P - 1)] + 1 + rank, -1)
    # int32 wrap-around, as the reference's int32 sums have it
    wrap = torch.remainder(pos + 2 ** 31, 2 ** 32) - 2 ** 31
    new = torch.remainder(lasts + counts + 2 ** 31, 2 ** 32) - 2 ** 31
    return wrap.to(torch.int32), new.to(torch.int32)


# ------------------------------------------------ single-pass models -----
# Plain-torch models of how csrc/segscan.cu's single-pass kernels bracket
# their scans: tiles of threads x items ops; each thread's items composed
# serially; warps scanned in lane order; each tile's prefix from a
# decoupled look-back over windows of WINDOW predecessors,
# nearest first, stopping at the nearest one that has published its
# inclusive prefix.  Which predecessors have done so when a tile looks
# depends on timing on the card: ``p_inclusive`` and ``seed`` draw it
# (tile 0 always has).  The tests hold these models bit for bit against
# the JAX package; their tile shapes are the launcher's, which a test holds
# against segscan.cu's.  The wrappers never call them.
QUEUE_ITEMS = TILE // QUEUE_THREADS    # ops a thread, each kernel
STACK_ITEMS = TILE // STACK_THREADS
TIER_ITEMS = TILE // TIER_THREADS
WINDOW = 32                            # predecessors a look-back warp reads

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def _seen_inclusive(tiles: int, p_inclusive: float, seed: int):
    g = torch.Generator().manual_seed(seed)
    seen = torch.rand(tiles, tiles, generator=g) < p_inclusive
    seen[:, 0] = True
    return seen


def _window(i: int, seen: torch.Tensor):
    """Tile i's look-back windows: for each, the predecessor of each lane
    (-1 before tile 0), whether it shows its inclusive prefix, and the
    lanes that count (up to the nearest inclusive one)."""
    top = i - 1
    lanes = torch.arange(WINDOW)
    while True:
        j = top - lanes
        inclusive = (j < 0) | seen[i, j.clamp(min=0)]
        stop = int(inclusive.to(torch.int8).argmax()) if inclusive.any() \
            else WINDOW - 1
        yield j, inclusive, lanes <= stop
        if inclusive.any():
            return
        top -= WINDOW


def _ident(b: int):
    """The identity transform (0, b, 0) of a composition, by shape."""
    def ident(shape):
        return (torch.zeros(shape, dtype=torch.int32),
                torch.full(shape, b, dtype=torch.int32),
                torch.zeros(shape, dtype=torch.int32))
    return ident


_queue_ident, _stack_ident = _ident(INF), _ident(-INF)


def _where(mask, x, y):
    return tuple(torch.where(mask, p, q) for p, q in zip(x, y))


def _lane_scan(t, lanes: int, compose):
    """Inclusive scan along the last axis as ``warp_incl``: at step off,
    lane l composes lane l - off's value before its own."""
    lane = torch.arange(lanes)
    off = 1
    while off < lanes:
        up = tuple(x.roll(off, -1) for x in t)
        t = _where(lane >= off, compose(up, t), t)
        off *= 2
    return t


def _tile_prefix_model(e, v, ops, compose, ident, threads: int, items: int,
                       p_inclusive: float, seed: int):
    """``tile_prefix`` and ``look_back`` on the CPU: each op's exclusive
    prefix transform and the composition of all ops, bracketed as the
    kernels bracket them.  ``ops(e, v)`` gives the per-op transforms of
    the bools; returns (e, v padded to whole tiles and shaped [tiles,
    warps, 32, items], the prefixes in that shape, the run)."""
    n = e.shape[0]
    tile, warps = threads * items, threads // 32
    tiles = max(-(-n // tile), 1)
    pad = torch.zeros(tiles * tile - n, dtype=torch.bool)
    shape = (tiles, warps, 32, items)
    e = torch.cat([e.to(torch.bool), pad]).reshape(shape)
    v = torch.cat([v.to(torch.bool), pad]).reshape(shape)
    ops = tuple(x.to(torch.int32) for x in ops(e, v))
    agg = ident(shape[:-1])
    for k in range(items):                     # each thread, serially
        agg = compose(agg, tuple(x[..., k] for x in ops))
    inc = _lane_scan(agg, 32, compose)
    lane_excl = _where(torch.arange(32) == 0, ident(shape[:-1]),
                       tuple(x.roll(1, -1) for x in inc))
    # warp 0 scans the warp totals; its lanes past the warps hold identity
    w = ident((tiles, 32))
    w = tuple(torch.cat([x[..., 31], y[:, warps:]], -1)
              for x, y in zip(inc, w))
    w_inc = tuple(x[:, :warps] for x in _lane_scan(w, 32, compose))
    tile_agg = tuple(x[:, -1] for x in w_inc)
    warp_excl = _where(torch.arange(warps) == 0, ident((tiles, warps)),
                       tuple(x.roll(1, -1) for x in w_inc))
    thread_excl = compose(tuple(x[..., None] for x in warp_excl), lane_excl)
    seen = _seen_inclusive(tiles, p_inclusive, seed)
    pre, incl = [], []
    for i in range(tiles):
        prefix = ident(())
        if i:
            for j, inclusive, counts in _window(i, seen):
                vals = ident((WINDOW,))
                for lane in range(WINDOW):
                    if counts[lane] and j[lane] >= 0:
                        jj = int(j[lane])
                        src = incl[jj] if inclusive[lane] else tuple(
                            x[jj] for x in tile_agg)
                        for x, y in zip(vals, src):
                            x[lane] = y
                lane_ids = torch.arange(WINDOW)
                off = 1                        # tree in lane order, as
                while off < WINDOW:            # shfl_down: higher = earlier
                    dn = tuple(x.roll(-off, -1) for x in vals)
                    vals = _where(lane_ids + off < WINDOW,
                                  compose(dn, vals), vals)
                    off *= 2
                prefix = compose(tuple(x[0] for x in vals), prefix)
        pre.append(prefix)
        incl.append(compose(prefix, tuple(x[i] for x in tile_agg)))
    pre = tuple(torch.stack([p[k] for p in pre]) for k in range(3))
    x = compose(tuple(p[:, None, None] for p in pre), thread_excl)
    excl = []
    for k in range(items):                     # each thread's ops again
        excl.append(x)
        x = compose(x, tuple(o[..., k] for o in ops))
    excl = tuple(torch.stack([p[k] for p in excl], -1) for k in range(3))
    return e, v, excl, incl[-1]


def _queue_ops(e, v):
    """valid ENQ (0, INF, 1), valid DEQ (1, 1, 0), invalid the identity."""
    return (v & ~e, torch.where(v & ~e, 1, INF), v & e)


def _stack_ops(e, v):
    """valid PUSH (1, -INF, 1), valid POP (-1, 0, 0), invalid identity."""
    return (torch.where(v, torch.where(e, 1, -1), 0),
            torch.where(v & ~e, 0, -INF), v & e)


def queue_scan_lookback_model(is_enq: torch.Tensor, valid: torch.Tensor,
                              first: torch.Tensor, last: torch.Tensor, *,
                              p_inclusive: float = 0.0, seed: int = 0):
    """The single-pass FIFO scan's decomposition (``queue_scan_lookback``)
    on the CPU, positions stepped from each thread's first state as the
    kernel steps them.  Same arguments and results as
    :func:`queue_scan_ref`."""
    n, items = is_enq.shape[0], QUEUE_ITEMS
    e, v, x, run = _tile_prefix_model(is_enq, valid, _queue_ops,
                                      queue_compose, _queue_ident,
                                      QUEUE_THREADS, items, p_inclusive,
                                      seed)
    f0, l0 = first.to(torch.int64), last.to(torch.int64)
    # each thread's (first, last) before its first op, stepped through its
    # ops as the kernel does
    f = torch.minimum(f0 + x[0][..., 0], l0 + x[1][..., 0])
    l = l0 + x[2][..., 0]
    pos = []
    for k in range(items):
        enq, deq = v[..., k] & e[..., k], v[..., k] & ~e[..., k]
        pos.append(torch.where(enq, l + 1, torch.where(deq & (f <= l), f,
                                                       -1)))
        l = l + enq.to(torch.int64)
        f = torch.where(deq, torch.minimum(f + 1, l + 1), f)
    pos = torch.stack(pos, -1).reshape(-1)[:n].to(torch.int32)
    new_first = torch.minimum(f0 + run[0], l0 + run[1])
    return (pos, pos != -1, new_first.to(torch.int32),
            (l0 + run[2]).to(torch.int32))


def stack_scan_lookback_model(is_push: torch.Tensor, valid: torch.Tensor,
                              last: torch.Tensor, ticket: torch.Tensor, *,
                              p_inclusive: float = 0.0, seed: int = 0):
    """The single-pass LIFO scan's decomposition (``stack_scan_lookback``)
    on the CPU.  Same arguments and results as :func:`stack_scan_ref`."""
    n = is_push.shape[0]
    e, v, x, run = _tile_prefix_model(is_push, valid, _stack_ops,
                                      stack_compose, _stack_ident,
                                      STACK_THREADS, STACK_ITEMS,
                                      p_inclusive, seed)
    l0, t0 = last.to(torch.int64), ticket.to(torch.int64)
    l_i = torch.maximum(l0 + x[0], x[1].to(torch.int64))
    pos = torch.where(v, torch.where(e, l_i + 1, torch.where(
        l_i >= 1, l_i, -1)), -1).reshape(-1)[:n].to(torch.int32)
    tick = _wrap32(t0 + x[2] + e.to(torch.int64)).reshape(-1)[:n]
    new_last = torch.maximum(l0 + run[0], run[1].to(torch.int64))
    return (pos, tick, pos != -1, new_last.to(torch.int32),
            _wrap32(t0 + run[2]))


def tiered_scan_lookback_model(enq: torch.Tensor, tier: torch.Tensor,
                               lasts: torch.Tensor, *,
                               p_inclusive: float = 0.0, seed: int = 0):
    """The single-pass tiered sweep's decomposition
    (``tiered_scan_lookback``) on the CPU: ranks by warp rounds of 32
    consecutive ops with per-warp running counts, per-tier sums over the
    look-back windows.  Same arguments and results as
    :func:`tiered_queue_scan_ref`."""
    P, n, items = lasts.shape[0], enq.shape[0], TIER_ITEMS
    tile, warps = TIER_THREADS * items, TIER_THREADS // 32
    tiles = max(-(-n // tile), 1)
    tier = tier.to(torch.int64)
    key = torch.where(enq.to(torch.bool) & (tier >= 0) & (tier < P), tier, -1)
    key = torch.cat([key, torch.full((tiles * tile - n,), -1)])
    key = key.reshape(tiles, warps, items, 32)   # [tile, warp, round, lane]
    tiers = torch.arange(P)
    seen = _seen_inclusive(tiles, p_inclusive, seed)
    lasts = lasts.to(torch.int64)
    cnt, incl, pos = [], [], []
    for i in range(tiles):
        hot = (key[i][..., None] == tiers).to(torch.int64)  # [w, r, l, P]
        in_round = hot.cumsum(2) - hot             # earlier lanes, same tier
        per_round = hot.sum(2)                     # [w, r, P]
        running = per_round.cumsum(1) - per_round  # earlier rounds
        per_warp = per_round.sum(1)                # [w, P]
        warp_excl = per_warp.cumsum(0) - per_warp  # earlier warps
        cnt.append(per_warp.sum(0))
        pre = torch.zeros(P, dtype=torch.int64)
        if i:
            for j, inclusive, counts in _window(i, seen):
                for lane in range(WINDOW):
                    if counts[lane] and j[lane] >= 0:
                        jj = int(j[lane])
                        pre += incl[jj] if inclusive[lane] else cnt[jj]
        incl.append(pre + cnt[-1])
        k = key[i].clamp(min=0)
        rank = (in_round.gather(-1, k[..., None])[..., 0]
                + running[:, :, None, :].expand_as(hot).gather(
                    -1, k[..., None])[..., 0]
                + warp_excl[:, None, None, :].expand_as(hot).gather(
                    -1, k[..., None])[..., 0])
        pos.append(torch.where(key[i] >= 0, lasts[k] + 1 + pre[k] + rank,
                               -1))
    pos = _wrap32(torch.stack(pos).reshape(-1)[:n])
    return pos, _wrap32(lasts + incl[-1])
