"""Plain version of the relaxed tier resolution: a host loop.

Counterpart of the reference's ``lax.scan`` in
``repro/core/scan_queue.py:priority_queue_scan`` (``relaxation > 0``),
which has no Pallas kernel.  Each dequeue, in wave order, takes the head
of the best non-empty tier p*, or the first tier in ``[p*, p* + k]``
whose head is owned by the dequeue's own shard (``head % n_shards ==
shard_of[i]``, a floor modulo as ``jnp.mod``).  Each step depends on the
one before, so this walks the wave's dequeues on the host: one
device-to-host copy of the wave's flags, nothing to synchronise with on
a CPU tensor.  p* never falls within a wave (the tier sizes are fixed
after the enqueues and the counts taken only rise), so each search
starts at the previous p*.  Heads are int32 and wrap, as in JAX.
"""
from __future__ import annotations

import torch

BOTTOM = -1


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as an int32 sum wraps."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def relaxed_deletemin_ref(deq: torch.Tensor, shard_of: torch.Tensor,
                          avail: torch.Tensor, firsts: torch.Tensor,
                          n_prios: int, relaxation: int, n_shards: int):
    """deq: [n] bool; shard_of: [n] int32; avail/firsts: [P] int32, the
    tier sizes after the wave's enqueues and the heads.  Returns (tier [n]
    int32, -1 where nothing was taken; pos [n] int32, ⊥ = -1; matched [n]
    bool; taken [P] int32; n_relaxed, a 0-d int32), on ``deq``'s device.
    Ties go to the lowest tier, as ``jnp.argmax`` gives them."""
    dev = deq.device
    n, P = deq.shape[0], n_prios
    avail_h, firsts_h = avail.tolist(), firsts.tolist()
    shard_h = shard_of.tolist()
    taken = [0] * P
    tier = [-1] * n
    pos = [BOTTOM] * n
    n_relaxed = 0
    pstar = 0
    for i in torch.nonzero(deq.cpu()).flatten().tolist():
        while pstar < P and avail_h[pstar] - taken[pstar] <= 0:
            pstar += 1
        if pstar == P:
            break                      # ⊥ for this and every later dequeue
        q = pstar
        for c in range(pstar, min(pstar + relaxation, P - 1) + 1):
            if (avail_h[c] - taken[c] > 0 and
                    _i32(firsts_h[c] + taken[c]) % n_shards == shard_h[i]):
                q = c
                break
        tier[i], pos[i] = q, _i32(firsts_h[q] + taken[q])
        taken[q] += 1
        n_relaxed += q != pstar

    def put(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)
    t = put(tier)
    return t, put(pos), t >= 0, put(taken), put(n_relaxed)


WINDOW = 32                      # tiers warp 0 holds in registers


def relaxed_window_model(deq: torch.Tensor, shard_of: torch.Tensor,
                         avail: torch.Tensor, firsts: torch.Tensor,
                         n_prios: int, relaxation: int, n_shards: int):
    """The CUDA kernel's walk, step for step, in plain Python: 32 tiers
    held "in lanes" (remaining size, head, and the head's floor modulo
    n_shards, taken again whenever the head moves: a +1 step of it would
    be wrong where the int32 head wraps and n_shards does not divide
    2^32),
    the window written back and moved up when ``[p*, p* + k]`` leaves it,
    a batch of up to 32 dequeues resolved at once where they all take p*
    (each would: p* keeps elements for it, and its shard owns p*'s head
    or no tier below p* in the window), one dequeue at a time otherwise,
    and the tiers past the window searched in "shared memory" when ``k >
    31``.  Its outputs must equal :func:`relaxed_deletemin_ref`'s; the
    tests hold it against the plain loop, so the kernel's bracketing is
    checked where there is no card.  Same signature and outputs."""
    dev = deq.device
    n, P, k = deq.shape[0], n_prios, min(relaxation, n_prios)
    avail_h, firsts_h = avail.tolist(), firsts.tolist()
    shard_h = shard_of.tolist()
    s_rem = list(avail_h)
    s_head = list(firsts_h)
    s_hmod = [f % n_shards for f in firsts_h]
    tier = [-1] * n
    pos = [BOTTOM] * n
    n_rel, base = 0, 0

    def load(b):
        return ([s_rem[b + j] if b + j < P else 0 for j in range(WINDOW)],
                [s_head[b + j] if b + j < P else 0 for j in range(WINDOW)],
                [s_hmod[b + j] if b + j < P else 0 for j in range(WINDOW)])
    rem, head, hmod = load(0)
    d_list = torch.nonzero(deq.cpu()).flatten().tolist()
    m, d = len(d_list), 0
    while d < m:
        ne = [r > 0 for r in rem]
        f = ne.index(True) if any(ne) else WINDOW
        hi = min(base + f + k, P - 1)
        if f == WINDOW or (f > 0 and hi > base + WINDOW - 1):
            for j in range(WINDOW):            # write back, move up
                if base + j < P:
                    s_rem[base + j], s_head[base + j] = rem[j], head[j]
                    s_hmod[base + j] = hmod[j]
            base += f
            if base >= P:
                break                          # ⊥ from here on
            rem, head, hmod = load(base)
            continue
        if hi <= base + WINDOW - 1:
            # the batch: dequeue d + j takes p* unless it stops the batch
            jb = WINDOW
            for j in range(WINDOW):
                if d + j >= m or j >= rem[f]:
                    jb = j
                    break
                s_j = shard_h[d_list[d + j]]
                lower = any(rem[c] > 0 and hmod[c] == s_j
                            for c in range(f + 1, hi - base + 1))
                if lower and _i32(head[f] + j) % n_shards != s_j:
                    jb = j
                    break
            for j in range(jb):
                tier[d_list[d + j]] = base + f
                pos[d_list[d + j]] = _i32(head[f] + j)
            rem[f] -= jb
            head[f] = _i32(head[f] + jb)
            hmod[f] = head[f] % n_shards
            d += jb
            if jb:
                continue
        # one dequeue: a relaxed serve, or a window wider than the lanes
        i, s = d_list[d], shard_h[d_list[d]]
        loc = [ne[j] and j >= f and base + j <= hi and hmod[j] == s
               for j in range(WINDOW)]
        ql = loc.index(True) if any(loc) else f
        served_past = None
        if not any(loc) and hi > base + WINDOW - 1:
            for c in range(base + WINDOW, hi + 1):
                if s_rem[c] > 0 and s_hmod[c] == s:
                    served_past = c
                    break
        if served_past is not None:
            c = served_past
            tier[i], pos[i] = c, s_head[c]
            s_rem[c] -= 1
            s_head[c] = _i32(s_head[c] + 1)
            s_hmod[c] = s_head[c] % n_shards
            n_rel += 1
        else:
            tier[i], pos[i] = base + ql, head[ql]
            rem[ql] -= 1
            head[ql] = _i32(head[ql] + 1)
            hmod[ql] = head[ql] % n_shards
            n_rel += ql != f
        d += 1
    for j in range(WINDOW):
        if base + j < P:
            s_rem[base + j] = rem[j]
    taken = [_i32(a - r) for a, r in zip(avail_h, s_rem)]

    def put(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)
    t = put(tier)
    return t, put(pos), t >= 0, put(taken), put(n_rel)
