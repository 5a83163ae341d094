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


LANES = 32                       # a walker warp
LANE_DEQ = 8                     # dequeues a lane tests in a pass
WALK = LANES * LANE_DEQ          # dequeues a warp tests; relaxed.cu's kWalk
WALKERS = 4                      # walker warps; relaxed.cu's kWalkers
WINDOW = WALKERS * WALK          # dequeues a window; relaxed.cu's kWindow
INT32_MAX = 2 ** 31 - 1


def modulo_recip(n: int) -> int:
    """``modulo.cuh``'s reciprocal of ``n``: floor((2^32 - 1) / n)."""
    return 0xFFFFFFFF // n


def fast_mod(x: int, n: int, m: int) -> int:
    """``FastMod::of``: uint32 ``x`` mod ``n`` from the reciprocal ``m``,
    a high product, a multiply-subtract and one compare and subtract."""
    r = x - ((x * m) >> 32) * n
    return r - n if r >= n else r


def fast_floor_mod(h: int, n: int, m: int) -> int:
    """``FastMod::floor_of``: the floor modulo of int32 ``h``, as
    ``jnp.mod``, without a division."""
    return fast_mod(h, n, m) if h >= 0 else n - 1 - fast_mod(-(h + 1), n, m)


def relaxed_walk_model(deq: torch.Tensor, shard_of: torch.Tensor,
                       avail: torch.Tensor, firsts: torch.Tensor,
                       n_prios: int, relaxation: int, n_shards: int):
    """The CUDA kernel's event-driven walk, pass for pass, in plain Python.

    Tier state (remaining size, head, the head's floor modulo n_shards by
    the kernel's reciprocal) in "shared memory", p*'s in "registers", and
    ``low``: the shards that own a head in ``(p*, p* + k]``, rebuilt only
    at an event.  The wave's dequeues go window by window, ``WINDOW`` at a
    time (fewer at the end).  A pass of the test over the window's
    unresolved part (the kernel's four walker warps, eight tests a lane,
    a minimum over the warps) finds the first dequeue that stops p*'s
    run: its run position ``u``
    reaches ``rem[p*]``, or its shard is in ``low`` and does not own
    ``head[p*] + u`` (``(hmod[p*] + u) mod n`` stepped 32 at a time,
    unless the run can cross the int32 wrap: then the floor modulo of each
    wrapped head).  The dequeues before it take p*.  The stopping dequeue
    is an event: p* ran dry (the next non-empty tier becomes p*; the
    dequeue is tested again) or a relaxed serve (the lowest tier in the
    window whose head its shard owns).  Each event is followed by another
    pass over the rest of the window.

    Returns :func:`relaxed_deletemin_ref`'s five outputs and a dict of the
    chain: ``steps`` (passes, the all-⊥ ones after every tier ran dry
    included), ``relaxed`` and ``dry`` events, ``chain_steps`` (their sum)
    and ``dequeues``.  The tests hold the outputs against the plain loop,
    so the kernel's walk is checked where there is no card; the kernel's
    clock build reports the same counts on the card."""
    dev = deq.device
    n, P, k = deq.shape[0], n_prios, min(relaxation, n_prios)
    m = modulo_recip(n_shards)
    spread = n_shards * -(-WINDOW // n_shards)    # >= WINDOW, multiple of n
    c32 = fast_mod(LANES, n_shards, m)
    avail_h, firsts_h = avail.tolist(), firsts.tolist()
    shard_h = shard_of.tolist()
    rem, head = list(avail_h), list(firsts_h)
    hmod = [fast_floor_mod(f, n_shards, m) for f in firsts_h]
    ring = torch.nonzero(deq.cpu()).flatten().tolist()   # producers' order
    total = len(ring)
    tier = [-1] * n
    pos = [BOTTOM] * n
    steps = dry = n_rel = 0

    def next_tier(c):
        while c < P and rem[c] <= 0:
            c += 1
        return c

    def window(p):
        hi = min(p + k, P - 1)
        return hi, {hmod[c] for c in range(p + 1, hi + 1) if rem[c] > 0}

    def owner(t, t0, head_p, hm_p, wraps):
        """The owner of p*'s head at run position t - t0, as the kernel's
        warp t // WALK, lane t % 32 takes it."""
        if wraps:
            return fast_floor_mod(_i32(head_p + t - t0), n_shards, m)
        tq, lane, e = t - t % WALK, t % LANES, t % WALK // LANES
        h = fast_mod((hm_p + tq + lane - t0 + spread) % 2 ** 32, n_shards,
                     m)
        h += e * c32
        for mult in (4, 2, 1):
            h = h - mult * n_shards if h >= mult * n_shards else h
        return h

    ps = next_tier(0)
    rem_p = head_p = hm_p = hi = 0
    low = set()
    if ps < P:
        rem_p, head_p, hm_p = rem[ps], head[ps], hmod[ps]
        hi, low = window(ps)
    d = 0
    while True:
        lim = min(WINDOW, total - d)
        if lim == 0:
            break
        t0 = 0
        while t0 < lim:
            steps += 1
            if ps == P:                # every tier ran dry: ⊥ stays
                break
            lim2 = min(lim, t0 + rem_p)
            wraps = head_p > INT32_MAX - (WINDOW - 1)
            jb = lim
            for t in range(t0, lim):   # the first dequeue that stops
                s = shard_h[ring[d + t]]
                if t >= lim2 or (s in low and
                                 owner(t, t0, head_p, hm_p, wraps) != s):
                    jb = t
                    break
            for t in range(t0, jb):
                tier[ring[d + t]] = ps
                pos[ring[d + t]] = _i32(head_p + t - t0)
            rem_p -= jb - t0
            head_p = _i32(head_p + jb - t0)
            hm_p = fast_floor_mod(head_p, n_shards, m)
            t0 = jb
            if rem_p == 0:             # event: p* ran dry
                rem[ps] = 0
                dry += 1
                ps = next_tier(ps + 1)
                if ps < P:
                    rem_p, head_p, hm_p = rem[ps], head[ps], hmod[ps]
                    hi, low = window(ps)
            elif jb < lim:             # event: a relaxed serve
                i = ring[d + jb]
                q = next(c for c in range(ps + 1, hi + 1)
                         if rem[c] > 0 and hmod[c] == shard_h[i])
                tier[i], pos[i] = q, head[q]
                rem[q] -= 1
                head[q] = _i32(head[q] + 1)
                hmod[q] = fast_floor_mod(head[q], n_shards, m)
                t0 += 1
                n_rel += 1
                hi, low = window(ps)
        d += lim
    if ps < P:
        rem[ps] = rem_p
    taken = [_i32(a - r) for a, r in zip(avail_h, rem)]

    def put(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)
    t = put(tier)
    stats = {"steps": steps, "relaxed": n_rel, "dry": dry,
             "chain_steps": steps + n_rel + dry, "dequeues": total}
    return t, put(pos), t >= 0, put(taken), put(n_rel), stats
