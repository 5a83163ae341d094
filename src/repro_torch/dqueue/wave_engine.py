"""The fused wave engine: Stages 1-4 once, disciplines plug in.

Counterpart of ``repro/dqueue/wave_engine.py``.  The reference runs one
wave inside ``shard_map`` on per-shard views; here every shard this
process holds is one row of the leading dimension of tensors on its
device (all of them on one process), and each of the reference's
``all_to_all`` collectives is one call of the runtime's exchange seam on
a ``[src_local, dst, L, C]`` send buffer.  On a multi-process runtime a
discipline's scan also needs the whole wave's op descriptors: one
``runtime.gather`` of them a wave (op bits; the priority tier or the
Seap key beside them), the reference's descriptor ``all_gather``
(``repro/dqueue/device_queue.py:361``).  A discipline (FIFO, LIFO,
priority tiers, Seap buckets) supplies

* **dispatch** (Stages 1-3): each op's position, owner shard and store
  slot, from one scan over the flat shard-major wave;
* **commit** (Stage-4 store rewrite): the received PUT/GET rows applied to
  the store, and the packed ``ok ‖ value`` reply.  The ring-store
  disciplines (FIFO, priority, Seap) call :func:`ring_commit`
  (``kernels/ring_commit``: one CUDA launch on the card, the plain
  version on the CPU).

The engine owns the ``slot ‖ tag ‖ payload`` request packing, the
exchanges, the reply extraction and the burst schedules.

Wave pipelining
---------------
``run_waves`` with ``pipelined=True`` (the default) runs iteration k as
dispatch of wave k, commit of wave k-1, then ONE exchange carrying wave
k's request columns beside wave k-1's reply columns.  Outputs come out one
iteration late: the priming iteration's row is dropped and the last wave
drains through a reply-only epilogue exchange.  A K-wave burst costs K+1
exchanges instead of 2K, and gives bit-identical results to
``pipelined=False``.

State
-----
The store tensors are updated in place (the reference donates them); the
``first``/``last`` scalars are new 0-d device tensors after each wave.  No
wave reads a device value on the host.

Telemetry
---------
With ``metrics=True`` every wave also writes one Wavescope row (ops
admitted per kind, ⊥ count, per-window occupancy, headroom, the
discipline's aux signal; ``obs.device``) into a device ring the engine
owns, at dispatch time and in wave order.  It is arithmetic on values the
wave already holds: no extra exchange, no host read, identical queue
outputs.  :meth:`WaveEngine.drain_metrics` is the one host read of it, at
burst boundaries.

Stage spans
-----------
Each wave body marks its stages with detail spans (``obs.trace``): a
profiler range while a profiler records, an event in the tracer's ring
while its detail switch is on, else nothing: ``wave:dispatch`` (Stages 1-3 and the telemetry row),
``wave:exchange`` (request packing, the request ‖ reply ``cat``, the
runtime's exchange, the reply's extraction) and ``wave:commit`` (the
Stage-4 rewrite and the reply).  A pipelined K-wave burst shows K
dispatch, K+1 exchange and K+1 commit ranges; a sequential one K, 2K and
K.  The spans read nothing on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.wave_tags import TAG_GET, TAG_INACTIVE, TAG_PUT
from ..kernels import backend
# ring_commit is the ring-store disciplines' commit, imported from here
from ..kernels.ring_commit import ring_commit  # noqa: F401
from ..obs.device import (MetricsState, drain as _drain_rows,
                          init_metrics_state, record_row)
from ..obs.trace import tracer

# the kernel libraries (csrc/<name>.cu) that every queue wave loads
WAVE_LIBS = ("segscan", "ring_commit")


def _stage(name: str):
    """The detail span of one wave stage (``wave:dispatch``,
    ``wave:exchange``, ``wave:commit``): a no-op unless a profiler records
    or the tracer's detail switch is on; it never reads the device."""
    return tracer.detail_span(name, "wave")


# ------------------------------------------------- occupancy buckets -------
def bucket_ladder(L: int) -> tuple:
    """The static ladder of per-shard envelope widths for full width
    ``L``: {L/4, L/2, L} deduplicated, ascending, floored at 1."""
    return tuple(sorted({max(1, L // 4), max(1, L // 2), L}))


def pick_bucket_width(L: int, n_shards: int, n_ops: int) -> int:
    """Smallest ladder width ``w`` with ``n_shards * w >= n_ops``; bursts
    larger than the full envelope return ``L``."""
    for w in bucket_ladder(L):
        if n_shards * w >= n_ops:
            return w
    return L


# ------------------------------------------------------ shared helpers -----
def post_enqueue_peak_overflow(first, new_last, capacity):
    """The post-enqueue-peak capacity check.

    A wave applies PUTs before GETs, so capacity must hold at the peak
    after the wave's enqueues: ``new_last - first + 1`` with ``first``
    from before the wave.  Returns a 0-d bool tensor (no host read).
    """
    return torch.any((new_last - first + 1) > capacity)


def build_send_packed(owner, cols, active, n_shards: int, fill):
    """Scatter each shard's op columns into its send buffer.

    owner/active: [n, L]; cols: [n, L, C]; fill: [C].  Returns
    ``[n_src, n_dst, L, C]``: row ``(s, d, j)`` holds op j of shard s if
    it is active and owned by d, else the ``fill`` sentinel column."""
    dst = torch.arange(n_shards, dtype=owner.dtype, device=owner.device)
    hit = (dst[None, :, None] == owner[:, None, :]) & active[:, None, :]
    return torch.where(hit[..., None], cols[:, None], fill)


# ------------------------------------------------- discipline contract -----
class Dispatch(NamedTuple):
    """What a discipline's Stages 1-3 hand to the engine for one wave.
    Per-op fields are ``[n_local, L]`` (one row per shard this process
    holds; ``owner`` is an index into the whole shard list)."""
    owner: torch.Tensor        # destination shard, -1 for unrouted ops
    slot: torch.Tensor         # destination slot (junk when unrouted)
    tag: torch.Tensor          # TAG_PUT / TAG_GET / TAG_INACTIVE
    extra: tuple               # extra request columns, each [n, L] int32
    payload: torch.Tensor      # [n, L, W] int32
    active: torch.Tensor       # rows that travel (matched ops)
    wants_reply: torch.Tensor  # ops whose reply is extracted (dequeues)
    outs: tuple                # dispatch-time per-op outputs, [n_local*L]
    carry: tuple               # updated interval carry (0-d tensors)
    overflow: torch.Tensor     # 0-d bool, dispatch-time capacity check
    aux: tuple                 # per-wave extras (0-d tensors)


class Discipline:
    """Position-assignment + store-rewrite plug-in for :class:`WaveEngine`.

    Subclasses define ``n_ops`` (op inputs per wave), ``n_disp_outs``
    (dispatch-time per-op outputs), ``n_aux`` (per-wave extras, e.g. the
    priority queue's relaxed-serve count) and ``extra_fill`` (sentinels of
    the extra request columns), the instance attributes ``W`` / ``junk``
    / ``n_windows`` / ``window_capacity`` (interval windows and the
    elements one of them holds, which the pressure API reads), and the
    methods below, which work on all of this process's shards at once
    (shards are the leading dimension).  ``local_overflow`` marks a
    commit-time overflow flag that each process computes over its own
    shards (the stack's), which a reader or-s over the processes.
    """

    n_ops: int = 3
    n_disp_outs: int = 2
    n_aux: int = 0
    extra_fill: tuple = ()
    n_windows: int = 1
    window_capacity: int = 0
    local_overflow: bool = False
    # set by bind(): the runtime and the shard list the waves run over;
    # ``local_rows`` holds this process's shards' indices in that list on
    # a multi-process runtime, None on one process
    runtime = None
    shards: tuple = ()
    local_rows = None

    def bind(self, runtime, shards) -> None:
        """Attach the runtime and the active shard list (the engine does)."""
        self.runtime, self.shards = runtime, list(shards)
        self.local_rows = (runtime.local_rows(shards)
                           if runtime.multi_process else None)

    def gather_ops(self, is_x, valid, key=None, *, key_column=False):
        """The wave's op descriptors, every shard's in active order: on a
        multi-process runtime ONE ``runtime.gather`` a wave; on one
        process the ops as they are.  Returns ``(is_x, valid)``, or
        ``(is_x, valid, key)`` when a ``key`` is given.

        The descriptor is the code ``2·is_x + valid``: ``[n_local, L]``
        uint8 (``n_shards·L`` bytes) without a key.  A priority tier rides
        above the code in one int32, ``key·4 + code`` (the reference's
        ``repro/dqueue/priority_queue.py:121-124``), so the tier every
        process reads is the key's low 30 bits, sign-extended, as there.
        An arbitrary int32 key (``key_column=True``, Seap) keeps a column
        of its own beside the code, ``[n_local, L, 2]``
        (``repro/dqueue/seap_queue.py:136``), so keys at the int32 edges
        survive whole."""
        if key is None:
            if self.local_rows is None:
                return is_x, valid
            code = is_x.to(torch.uint8) * 2 + valid.to(torch.uint8)
        else:
            key = key.to(torch.int32)
            if self.local_rows is None:
                return is_x, valid, key if key_column else (key * 4) >> 2
            code = is_x.to(torch.int32) * 2 + valid.to(torch.int32)
            code = (torch.stack([code, key], -1) if key_column
                    else code + key * 4)
        g = self.runtime.gather(
            code.view(self.local_rows.numel(), -1, *code.shape[1:]),
            self.shards).reshape(-1, *code.shape[1:])
        c = g[:, 0] if key_column else g
        out = ((c & 2) > 0, (c & 1) > 0)
        if key is None:
            return out
        return out + (g[:, 1] if key_column else g >> 2,)

    def local(self, x):
        """A whole wave's per-op values ``[n_shards·L, ...]`` -> this
        process's shards' rows ``[n_local, L, ...]``."""
        x2 = x.view(self.n_shards, -1, *x.shape[1:])
        return x2 if self.local_rows is None else x2.index_select(
            0, self.local_rows)

    def split(self, state):
        """state -> (interval carry tuple, store tuple)."""
        raise NotImplementedError

    def merge(self, carry, store):
        """(carry, store) -> state (inverse of split)."""
        raise NotImplementedError

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3 for one wave; ``ops`` are this process's flat
        ``[n_local*L]`` arrays."""
        raise NotImplementedError

    def commit(self, store, recv):
        """Stage-4 rewrite: -> (store, reply [n_local, n, L, 1+W],
        commit_ovf)."""
        raise NotImplementedError

    def zero_outs(self, nL: int, device) -> tuple:
        """Dtype-correct filler for ``Dispatch.outs`` (pipeline priming)."""
        raise NotImplementedError

    def zero_aux(self, device) -> tuple:
        """Dtype-correct zeros for ``Dispatch.aux`` (pipeline priming)."""
        return ()

    def occupancy(self, carry) -> torch.Tensor:
        """``[n_windows]`` int32 occupancy from a (post-dispatch) interval
        carry: arithmetic on device tensors, for the metrics row."""
        raise NotImplementedError


# --------------------------------------------------------- the engine ------
class WaveEngine:
    """One fused wave body for the device structures.

    ``step`` runs one sequential wave (two exchanges: packed request +
    packed reply).  ``run_waves`` executes K pre-staged waves, pipelined
    (K+1 exchanges) or sequential (2K).  Both update the state's store in
    place and return the new state.  With ``metrics=True`` each wave also
    writes a row into the engine's ``metrics_ring``-row telemetry ring
    (see the module docstring); the exchanges stay the same.  ``shards``
    is the active shard list (default the runtime's first ``n_shards``);
    ops and per-op outputs are this process's shards' rows of the wave.
    """

    def __init__(self, n_shards: int, discipline: Discipline, runtime, *,
                 shards=None, pipelined: bool = True, metrics: bool = False,
                 metrics_ring: int = 64):
        if runtime.device.type == "cuda":
            # a wave runs a scan and the commit: at a checkout's first
            # run the two build in one parallel nvcc round
            backend.build(WAVE_LIBS)
        self.n_shards = n_shards
        self.shards = (list(runtime.pool()[:n_shards]) if shards is None
                       else list(shards))
        if len(self.shards) != n_shards:
            raise ValueError(f"{len(self.shards)} shards for n_shards="
                             f"{n_shards}")
        self.n_local = len(runtime.local_shards(self.shards))
        discipline.bind(runtime, self.shards)
        self.disc = discipline
        self.runtime = runtime
        self.pipelined = pipelined
        self.metrics = bool(metrics)
        self.metrics_ring = int(metrics_ring)
        self._mstate = self.init_metrics_state() if self.metrics else None
        self._seq0 = 0  # waves drained-and-reset before the current ring
        d = discipline
        # the inactive request row, made once: a host-to-device copy per
        # wave would wait for the stream
        self._fill = torch.tensor(
            [d.junk, *d.extra_fill, TAG_INACTIVE] + [0] * d.W,
            dtype=torch.int32, device=runtime.device)

    # --------------------------------------------------- request packing ---
    def _pack_request(self, d: Dispatch):
        cols = torch.cat(
            [d.slot[..., None]]
            + [e.to(torch.int32)[..., None] for e in d.extra]
            + [d.tag.to(torch.int32)[..., None], d.payload], -1)
        return build_send_packed(d.owner, cols, d.active, self.n_shards,
                                 self._fill)

    def _exchange(self, buf):
        return self.runtime.exchange(buf, self.shards)

    def _extract_reply(self, back, owner, wants_reply):
        """Local shard s's op j finds its reply at ``back[s, owner[s, j],
        j]``.  Returns flat (vals [n_local*L, W], ok [n_local*L])."""
        n, L = owner.shape
        dev = owner.device
        own_row = owner.clamp(0, back.shape[1] - 1).long()
        s = torch.arange(n, device=dev)[:, None]
        j = torch.arange(L, device=dev)[None, :]
        got = back[s, own_row, j]                       # [n, L, 1+W]
        vals = torch.where(wants_reply[..., None], got[..., 1:], 0)
        ok = wants_reply & (got[..., 0] > 0)
        return vals.reshape(n * L, -1), ok.reshape(n * L)

    # ---------------------------------------------------------- metrics ----
    def _metric_row(self, d: Dispatch, ops) -> torch.Tensor:
        """One Wavescope row per shard, ``[n_shards, M]`` int32, from
        values the wave holds at dispatch time: each shard's counters over
        its ``[L]`` slice, and the replicated seq, aux, headroom, width
        and occupancy (``[n_local, M]`` on a multi-process runtime).  No
        exchange, no host read."""
        disc, n = self.disc, self.n_local
        i32 = torch.int32
        valid = ops[1].reshape(n, -1)
        puts = ((d.tag == TAG_PUT) & d.active).sum(1, dtype=i32)
        gets = ((d.tag == TAG_GET) & d.active).sum(1, dtype=i32)
        offered = valid.sum(1, dtype=i32)
        bottom = (valid & ~d.active).sum(1, dtype=i32)
        occ = disc.occupancy(d.carry).to(i32)
        headroom = disc.n_windows * disc.window_capacity - occ.sum(dtype=i32)
        aux = (d.aux[0].to(i32) if d.aux
               else torch.zeros((), dtype=i32, device=valid.device))
        width = torch.full((n,), valid.shape[1], dtype=i32,
                           device=valid.device)
        head = torch.stack([self._mstate.count.expand(n), puts, gets,
                            offered, bottom, aux.expand(n),
                            headroom.to(i32).expand(n), width], 1)
        return torch.cat([head, occ.expand(n, -1)], 1)

    def _record(self, d: Dispatch, ops) -> None:
        if self.metrics:
            self._mstate = record_row(self._mstate, self._metric_row(d, ops))

    # ------------------------------------------------------- wave bodies ---
    def _wave(self, state, ops):
        """One sequential wave: dispatch -> request exchange -> commit ->
        reply exchange -> extract.  Exactly two exchanges, with or
        without the metrics row."""
        disc = self.disc
        carry, store = disc.split(state)
        with _stage("dispatch"):
            d = disc.dispatch(carry, ops)
            self._record(d, ops)
        with _stage("exchange"):
            recv = self._exchange(self._pack_request(d))
        with _stage("commit"):
            store, reply, c_ovf = disc.commit(store, recv)
        with _stage("exchange"):
            back = self._exchange(reply)
            dv, dok = self._extract_reply(back, d.owner, d.wants_reply)
        outs = d.outs + (dv, dok, d.overflow | c_ovf) + d.aux
        return disc.merge(d.carry, store), outs

    def _multi_sequential(self, state, ops):
        rows = []
        for k in range(ops[0].shape[0]):
            state, outs = self._wave(state, tuple(x[k] for x in ops))
            rows.append(outs)
        return (state,) + tuple(torch.stack(c) for c in zip(*rows))

    def _multi_pipelined(self, state, ops):
        """K waves, software-pipelined: iteration k dispatches wave k and
        commits wave k-1; ONE exchange carries wave k's request columns
        beside wave k-1's reply columns.  Outputs are emitted at commit
        time, so they shift by one wave and the last wave drains through a
        reply-only epilogue exchange."""
        disc = self.disc
        n, n_loc = self.n_shards, self.n_local
        K, nL = ops[0].shape[0], ops[0].shape[1]
        L = nL // n_loc
        dev = ops[0].device
        C_req = 2 + len(disc.extra_fill) + disc.W
        carry, store = disc.split(state)
        # an all-sentinel in-flight buffer commits as a no-op
        infl = {"recv": self._fill.expand(n_loc, n, L, C_req),
                "owner": torch.full((n_loc, L), -1, dtype=torch.int32,
                                    device=dev),
                "wants": torch.zeros((n_loc, L), dtype=torch.bool,
                                     device=dev),
                "outs": disc.zero_outs(nL, dev),
                "ovf": torch.zeros((), dtype=torch.bool, device=dev),
                "aux": disc.zero_aux(dev)}
        rows = []
        for k in range(K):
            xs = tuple(x[k] for x in ops)
            with _stage("dispatch"):
                d = disc.dispatch(carry, xs)                        # wave k
                self._record(d, xs)
            with _stage("commit"):
                store, reply, c_ovf = disc.commit(store,
                                                  infl["recv"])     # k-1
            with _stage("exchange"):
                out = self._exchange(torch.cat([self._pack_request(d),
                                                reply], -1))
                dv, dok = self._extract_reply(out[..., C_req:],
                                              infl["owner"], infl["wants"])
            if k > 0:      # iteration 0 emits the priming wave: dropped
                rows.append(infl["outs"] + (dv, dok, infl["ovf"] | c_ovf)
                            + infl["aux"])
            infl = {"recv": out[..., :C_req], "owner": d.owner,
                    "wants": d.wants_reply, "outs": d.outs,
                    "ovf": d.overflow, "aux": d.aux}
            carry = d.carry
        # epilogue: commit the last in-flight wave, reply-only exchange
        with _stage("commit"):
            store, reply, c_ovf = disc.commit(store, infl["recv"])
        with _stage("exchange"):
            back = self._exchange(reply)
            dv, dok = self._extract_reply(back, infl["owner"], infl["wants"])
        rows.append(infl["outs"] + (dv, dok, infl["ovf"] | c_ovf)
                    + infl["aux"])
        return ((disc.merge(carry, store),)
                + tuple(torch.stack(c) for c in zip(*rows)))

    # ------------------------------------------------------ entry points ---
    def step(self, state, *ops):
        """One wave; ops are flat ``[n_local * L]`` (this process's
        shards' rows; ``[n_shards * L]`` on one process).  The store of
        ``state`` is updated in place.  Returns (new_state, *outs)."""
        st, outs = self._wave(state, ops)
        return (st,) + outs

    def run_waves(self, state, *ops):
        """K pre-staged waves (ops ``[K, n_shards * L]``), no host sync
        between them (ops ``[K, n_local * L]`` on a multi-process
        runtime).  The store of ``state`` is updated in place.  Every
        output comes back ``[K]``-stacked, the discipline's aux too."""
        if ops[0].shape[0] == 0:
            raise ValueError("run_waves needs at least one wave")
        body = (self._multi_pipelined if self.pipelined
                else self._multi_sequential)
        return body(state, ops)

    # ----------------------------------------------------- metrics drain ---
    def init_metrics_state(self) -> MetricsState:
        """A zeroed telemetry ring on this engine's device."""
        return init_metrics_state(self.n_local, self.metrics_ring,
                                  self.disc.n_windows, self.runtime.device)

    def drain_metrics(self, *, reset: bool = False) -> list:
        """The ring's rows as host wave-summary dicts, oldest first: the
        one host read of the telemetry, for burst boundaries.  With
        ``reset=True`` the ring restarts empty and the sequence number
        keeps running.  On a multi-process runtime the ring's shard rows
        are gathered first (one ``runtime.gather``)."""
        if not self.metrics:
            return []
        m = self._mstate
        if self.runtime.multi_process:
            m = MetricsState(m.count, self.runtime.gather(m.rows,
                                                          self.shards))
        rows = _drain_rows(m)
        for r in rows:
            r["seq"] += self._seq0
        if reset:
            self._seq0 += int(self._mstate.count)
            self._mstate = self.init_metrics_state()
        return rows


# -------------------------------------------------- migration machinery ----
def dest_rank(owner: torch.Tensor, live: torch.Tensor,
              n_mesh: int) -> torch.Tensor:
    """Exclusive rank of each live entry among earlier live entries of the
    same source row with the same destination: its row in the packed
    per-destination send buffer.

    owner/live: ``[n_src, T]``.  The reference takes a one-hot cumsum,
    ``[T, n_mesh]`` per shard; a stable sort by destination gives the
    same ranks for live entries in ``O(n_src * T)`` memory.  Entries that
    are not live get ranks that no caller reads."""
    key = torch.where(live, owner, n_mesh).to(torch.int64)
    skey, order = torch.sort(key, dim=1, stable=True)
    run_start = torch.searchsorted(skey, skey)        # first index of key
    idx = torch.arange(key.shape[1], device=key.device).expand_as(key)
    return torch.empty_like(key).scatter_(1, order, idx - run_start)


def fanout_bound(P_old: int, P_new: int, cap: int) -> int:
    """Max elements one source shard can owe one destination shard.

    Live positions occupy a window of at most ``min(P_old, P_new) * cap``
    consecutive integers; positions on shard ``s`` (mod P_old) owned by
    ``d`` (mod P_new) recur with stride ``lcm(P_old, P_new)``."""
    window = min(P_old, P_new) * cap
    per_pair = -(-window // math.lcm(P_old, P_new))
    return min(cap, per_pair + 1)  # +1 alignment slack


def recover_positions(s, t, first, P_old: int, cap: int):
    """Invert the round-robin layout: slot ``t`` of shard ``s`` holds the
    unique ``p = s + P_old*j`` with ``j ≡ t (mod cap)`` and ``p`` in the
    live window starting at ``first``.  Floor division and modulo round
    toward -inf, as in the reference (``s - first`` is often negative)."""
    j_lo = -torch.div(s - first, P_old, rounding_mode="floor")
    j = j_lo + torch.remainder(t - j_lo, cap)
    return s + P_old * j


def migrate_packed(runtime, old, new, M: int, live, owner, cols, fill):
    """The ONE packed migration exchange, from the shard list ``old`` to
    ``new``: scatter each local source row's ``cols`` (column 0 =
    destination slot / junk sentinel) into rank-within-destination rows,
    exchange, and return the received rows ``[n_new_local, len(old) * M,
    C]`` per local destination, this process's moved count (0-d) and
    fanout-overflow flag (0-d bool).

    live/owner: ``[n_old_local, T]`` (owner indexes ``new``); cols:
    ``[n_old_local, T, C]``; fill: ``[C]``.
    """
    n_src, _, C = cols.shape
    n_dst = len(new)
    dev = cols.device
    rank = dest_rank(owner, live, n_dst)
    lost = (live & (rank >= M)).any()
    buf = fill.expand(n_src, n_dst, M + 1, C).clone()
    src = torch.arange(n_src, device=dev)[:, None].expand_as(owner)
    d_i = torch.where(live, owner, 0).long()
    r_i = torch.where(live, rank.clamp_max(M), M).long()
    buf[src, d_i, r_i] = torch.where(live[..., None], cols, fill)
    recv = runtime.exchange(buf[:, :, :M], old, new)
    moved = live.sum()
    return recv.reshape(recv.shape[0], -1, C), moved, lost


def rewrite_ring_store(rows, junk: int, W: int):
    """Rebuild a dense ring store from received ``new_slot ‖ payload``
    migration rows ``[n, R, 1+W]`` (sentinel rows land on, and are wiped
    from, the junk row).  Returns fresh (store_vals, store_full)."""
    n = rows.shape[0]
    dev = rows.device
    shard = torch.arange(n, device=dev)[:, None].expand(n, rows.shape[1])
    rs = rows[..., 0].long()
    nsv = torch.zeros((n, junk + 1, W), dtype=torch.int32, device=dev)
    nsv[shard, rs] = rows[..., 1:]
    nsv[:, junk] = 0
    nsf = torch.zeros((n, junk + 1), dtype=torch.bool, device=dev)
    nsf[shard, rs] = True
    nsf[:, junk] = False
    return nsv, nsf
