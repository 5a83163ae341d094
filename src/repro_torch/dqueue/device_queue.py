"""Device-resident distributed queue and stack: disciplines over the engine.

Counterpart of ``repro/dqueue/device_queue.py``.  Position
``p`` lives on shard ``p % n_shards`` at slot ``(p // n_shards) % cap``: a
dense sharded ring buffer, here ``store_vals [n_shards, cap+1, W]`` on one
device with the extra slot as the junk row.  One ``step`` is one paper
wave: position assignment by the min-plus scan (Stages 1-3, the segscan
kernel over the flat shard-major wave), then PUT/GET through the
exchange seam (Stage 4), PUTs before GETs.

The stack (paper Sec. VI) reuses positions, so each of its store slots
keeps a set of ``D`` (ticket, payload) entries, ticket -1 meaning empty:
``vals [n_shards, cap+1, D, W]``, ``ticks [n_shards, cap+1, D]``.  Its
positions and tickets come from the max-plus stack-scan kernel, and a pop
takes the largest ticket at its slot that is not above its bound, which
makes concurrent pops conflict-free.

On a multi-process runtime (:class:`~repro_torch.runtime.
DistributedRuntime`) a process holds its own shards' store rows and
passes its own shards' ops; each wave first gathers every shard's op
bits (one ``runtime.gather`` of ``n_shards·L`` bytes), then every process
runs the one scan launch over the whole wave and keeps its shards' slice
of the positions.  The new interval carry is replicated, since every
process computes it.  For the stack this is the reference's own pattern
(``repro/dqueue/device_queue.py:358-369``); for the queue it gives the
positions of the reference's hypercube ``sharded_queue_scan``
(``core/scan_queue.py:459``) by construction.  A per-process carry could
not serve: once a LEAVE and a JOIN interleave the active order, a
process's shards are not contiguous in the wave's global op order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.segscan import queue_scan, stack_scan
from ..runtime import LocalRuntime, Runtime
from .wave_engine import (TAG_GET, TAG_INACTIVE, TAG_PUT, Discipline,
                          Dispatch, WaveEngine, post_enqueue_peak_overflow,
                          ring_commit)


class DeviceQueueState(NamedTuple):
    """FIFO queue state: the ``[first, last]`` live window (0-d int32
    device tensors) plus the ring store (``store_vals [n_shards, cap+1, W]``
    int32, ``store_full [n_shards, cap+1]`` bool; the extra slot is the
    junk row)."""

    first: torch.Tensor
    last: torch.Tensor
    store_vals: torch.Tensor
    store_full: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        """Live element count (``last - first + 1``), a 0-d tensor."""
        return self.last - self.first + 1


class FifoDiscipline(Discipline):
    """SKUEUE FIFO order: min-plus segscan + dense-ring commit."""

    n_ops = 3           # (is_enq, valid, payload)
    n_disp_outs = 2     # (pos, matched)

    def __init__(self, n_shards: int, cap: int, W: int):
        self.n_shards = n_shards
        self.cap = cap
        self.W = W
        self.junk = cap
        self.window_capacity = n_shards * cap

    def split(self, state):
        """Split state into its (interval carry, store) halves."""
        return (state.first, state.last), (state.store_vals,
                                           state.store_full)

    def merge(self, carry, store):
        """Reassemble the full state from (carry, store) halves."""
        return DeviceQueueState(carry[0], carry[1], store[0], store[1])

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3: one segscan over the whole flat wave (its op bits
        gathered on a multi-process runtime), then owners and slots as
        this process's ``[n_local, L]`` rows."""
        is_enq_l, valid_l, payload = ops
        n = self.n_shards
        is_enq, valid = self.gather_ops(is_enq_l, valid_l)
        pos, matched, new_first, new_last = queue_scan(
            is_enq, valid, carry[0], carry[1])
        p2, m2 = self.local(pos), self.local(matched)
        e2 = is_enq_l.view(p2.shape)
        owner = torch.where(m2, torch.remainder(p2, n), -1).to(torch.int32)
        slot = torch.where(
            m2, torch.remainder(torch.div(p2, n, rounding_mode="floor"),
                                self.cap), self.cap).to(torch.int32)
        tag = torch.where(m2 & e2, TAG_PUT,
                          torch.where(m2 & ~e2, TAG_GET, TAG_INACTIVE))
        ovf = post_enqueue_peak_overflow(carry[0], new_last,
                                         n * self.cap)
        return Dispatch(owner, slot, tag.to(torch.int32), (),
                        payload.reshape(*p2.shape, self.W), m2, m2 & ~e2,
                        (p2.reshape(-1), m2.reshape(-1)),
                        (new_first, new_last), ovf, ())

    def commit(self, store, recv):
        """Stage 4: apply each shard's routed requests to its store."""
        return ring_commit(store, recv, self.junk, self.W)

    def zero_outs(self, nL: int, device) -> tuple:
        """All-invalid per-op dispatch outputs (pipeline priming)."""
        return (torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.zeros((nL,), dtype=torch.bool, device=device))

    def occupancy(self, carry):
        """The one window's occupancy, ``[1]``."""
        return (carry[1] - carry[0] + 1).reshape(1)


ROADMAP_MULTI_PROCESS = "ROADMAP queue 1, item 8"

# What the reference itself runs on one process only: it reads a sharded
# array on the host, and its DistributedRuntime reads only fully
# replicated arrays there (repro/runtime/distributed.py:18-20).  Both
# raise RuntimeError on its two-process launcher.
REFERENCE_LIMITS = {
    "WorkQueue": "its WorkQueue reads the sharded dequeue outputs with "
                 "np.asarray (repro/dqueue/work_queue.py:178-179)",
    "save": "its save_checkpoint reads every leaf with jax.device_get "
            "(repro/checkpoint/checkpointer.py:53)",
}


def check_runtime(runtime, what: str, limit: Optional[str] = None):
    """``runtime`` if ``what`` runs on it: any of the port's runtimes; a
    multi-process one unless ``limit`` (a key of ``REFERENCE_LIMITS``)
    names the reference's own reason not to run ``what`` there."""
    if not isinstance(runtime, Runtime):
        raise NotImplementedError(
            f"{type(runtime).__name__} is not one of the port's runtimes "
            "(LocalRuntime, SimRuntime, DistributedRuntime); others wait "
            f"({ROADMAP_MULTI_PROCESS})")
    if runtime.multi_process and limit is not None:
        raise NotImplementedError(
            f"{what} runs on one process only, as in the reference: "
            f"{REFERENCE_LIMITS[limit]}, and the reference's runtime reads "
            "only fully replicated arrays on the host "
            "(repro/runtime/distributed.py:18-20)")
    return runtime


def _make_runtime(n_shards: int, runtime, device, what: str):
    """The runtime of a fixed-size structure: a LocalRuntime over
    ``n_shards`` on ``device`` by default."""
    if runtime is None:
        return LocalRuntime(n_shards, device=device)
    return check_runtime(runtime, what)


class DeviceQueue:
    """Distributed FIFO over ``n_shards`` shards on one device.

    Args:
      n_shards: shards (the reference's mesh axis size).
      cap: slots per shard; payload_width: int32 words per element;
      ops_per_shard: wave width L.
      fused: True (default) runs the two-exchange engine wave; False the
        reference's five-exchange seed wave (``_legacy_wave``), the
        differential baseline, always sequential.
      pipelined: multi-wave bursts overlap wave k's dispatch with wave
        k-1's commit (K+1 exchanges); False keeps the sequential schedule.
        Results are identical either way.  Only meaningful with
        ``fused=True``: ``self.pipelined`` reports False for the seed path.
      metrics: write a Wavescope row per wave into a ``metrics_ring``-row
        device ring (``drain_metrics``); needs ``fused=True``.
      runtime: a :class:`~repro_torch.runtime.LocalRuntime`,
        :class:`~repro_torch.runtime.SimRuntime` or
        :class:`~repro_torch.runtime.DistributedRuntime`; default a
        LocalRuntime over ``n_shards`` shards on ``device``.
      shards: the active shard list (default the runtime's first
        ``n_shards``).  On a multi-process runtime the state holds this
        process's shards' rows, and ops and per-op outputs are their
        ``[n_local * L]`` rows of the wave (``runtime.place`` and
        ``runtime.to_host`` with the same list convert).
      device: where state and waves live; default CUDA (raises if absent).
    """

    def __init__(self, n_shards: int, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 fused: bool = True, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 runtime=None, shards=None, device=None):
        if metrics and not fused:
            raise ValueError("Wavescope metrics need the fused engine path "
                             "(fused=True)")
        runtime = _make_runtime(n_shards, runtime, device, "DeviceQueue")
        self.runtime = runtime
        self.device = runtime.device
        self.n_shards = n_shards
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.fused = fused
        self.pipelined = pipelined and fused  # the seed path is sequential
        self.metrics = bool(metrics)
        self.disc = FifoDiscipline(n_shards, cap, payload_width)
        self.engine = WaveEngine(n_shards, self.disc, runtime, shards=shards,
                                 pipelined=pipelined, metrics=metrics,
                                 metrics_ring=metrics_ring)
        self.shards, self.n_local = self.engine.shards, self.engine.n_local
        if not fused:      # the seed wave keeps the discipline, not the engine
            self.engine = None

    def init_state(self) -> DeviceQueueState:
        """An empty queue on this structure's device (this process's
        shards' store rows)."""
        n, cap, W, dev = self.n_local, self.cap, self.W, self.device
        return DeviceQueueState(
            first=torch.tensor(0, dtype=torch.int32, device=dev),
            last=torch.tensor(-1, dtype=torch.int32, device=dev),
            store_vals=torch.zeros((n, cap + 1, W), dtype=torch.int32,
                                   device=dev),
            store_full=torch.zeros((n, cap + 1), dtype=torch.bool,
                                   device=dev))

    def step(self, state: DeviceQueueState, is_enq: torch.Tensor,
             valid: torch.Tensor, payload: torch.Tensor):
        """Process one global batch; the store of ``state`` is updated in
        place.

        is_enq/valid: [n_local * L] bool; payload: [n_local * L, W] int32
        (``n_local == n_shards`` on one process).  Returns (new_state,
        positions, matched, deq_vals, deq_ok, overflow).
        """
        if self.engine is None:
            st, outs = self._legacy_wave(state, (is_enq, valid, payload))
            return (st,) + outs
        return self.engine.step(state, is_enq, valid, payload)

    def run_waves(self, state: DeviceQueueState, is_enq: torch.Tensor,
                  valid: torch.Tensor, payload: torch.Tensor):
        """Execute K pre-staged waves with no host sync between them; the
        store of ``state`` is updated in place.

        is_enq/valid: [K, n_shards * L] bool; payload: [K, n_shards * L, W]
        int32.  Wave k's global order follows wave k-1's.  Returns
        (new_state, positions [K, n], matched [K, n], deq_vals [K, n, W],
        deq_ok [K, n], overflow [K]).
        """
        if self.engine is not None:
            return self.engine.run_waves(state, is_enq, valid, payload)
        if is_enq.shape[0] == 0:
            raise ValueError("run_waves needs at least one wave")
        rows = []
        for k in range(is_enq.shape[0]):
            state, outs = self._legacy_wave(state, (is_enq[k], valid[k],
                                                    payload[k]))
            rows.append(outs)
        return (state,) + tuple(torch.stack(c) for c in zip(*rows))

    def drain_metrics(self, *, reset: bool = False) -> list:
        """Burst-boundary Wavescope drain (empty when metrics are off)."""
        return self.engine.drain_metrics(reset=reset) if self.engine else []

    # ------------------------------------------ seed five-exchange wave ----
    def _legacy_wave(self, state: DeviceQueueState, ops):
        """The reference's seed wave (``repro/dqueue/device_queue.py:
        _legacy_wave``), the differential baseline of the fused path:
        the same dispatch, then FIVE exchanges, one column each: PUT
        slots and PUT payloads, commit the PUTs; GET slots, read and
        remove; reply values and reply flags.  Returns (state, outs)."""
        rt, n, cap, W = self.runtime, self.n_shards, self.cap, self.W
        n_loc, sh = self.n_local, self.shards
        carry, (sv, sf) = self.disc.split(state)
        d = self.disc.dispatch(carry, ops)
        dev = sv.device
        svf, sff = sv.view(-1, W), sf.view(-1)
        base = (torch.arange(n_loc, device=dev) * (cap + 1)).view(n_loc, 1, 1)
        dst = torch.arange(n, dtype=torch.int32, device=dev)
        to_dst = d.owner[:, None, :] == dst[None, :, None]   # [src, dst, L]

        # ---- stage 4a: PUT dispatch (enqueues) ----
        put = to_dst & (d.tag == TAG_PUT)[:, None, :]
        r_slot = rt.exchange(torch.where(put, d.slot[:, None, :], cap), sh)
        r_vals = rt.exchange(torch.where(put[..., None],
                                         d.payload[:, None], 0), sh)
        flat = (base + r_slot).reshape(-1)
        svf[flat] = r_vals.reshape(-1, W)            # the junk row eats
        sff.index_fill_(0, flat, True)
        sf[:, cap] = False

        # ---- stage 4b: GET dispatch (dequeues) ----
        get = to_dst & d.wants_reply[:, None, :]
        g_slot = rt.exchange(torch.where(get, d.slot[:, None, :], cap), sh)
        g_flat = base + g_slot                       # [dst, src, L]
        res_vals = svf[g_flat]
        res_ok = sff[g_flat] & (g_slot < cap)
        sff.index_fill_(0, g_flat.reshape(-1), False)  # remove on read
        sf[:, cap] = False
        back_vals = rt.exchange(res_vals, sh)        # [src, dst, L, W]
        back_ok = rt.exchange(res_ok, sh)
        s = torch.arange(n_loc, device=dev)[:, None]
        j = torch.arange(d.owner.shape[1], device=dev)[None, :]
        own = d.owner.clamp(0, n - 1).long()
        deq_vals = torch.where(d.wants_reply[..., None], back_vals[s, own, j],
                               0).reshape(-1, W)
        deq_ok = (d.wants_reply & back_ok[s, own, j]).reshape(-1)
        pos, matched = d.outs
        return (self.disc.merge(d.carry, (sv, sf)),
                (pos, matched, deq_vals, deq_ok, d.overflow))


# ------------------------------------------------------------ LIFO ---------
class DeviceStackState(NamedTuple):
    """Stack state: ``last`` (the top; positions start at 1) and the
    monotone push ``ticket`` (0-d int32 device tensors), plus the store
    ``vals [n_shards, cap+1, D, W]`` int32 and ``ticks [n_shards, cap+1,
    D]`` int32 (-1 = empty entry; slot ``cap`` is the junk slot).  The
    reference keeps the same four arrays in a dict under these keys."""

    last: torch.Tensor
    ticket: torch.Tensor
    vals: torch.Tensor
    ticks: torch.Tensor


class LifoDiscipline(Discipline):
    """Stack order (paper Sec. VI): the max-plus stack scan plus the
    (slot, depth) ticket-set commit."""

    n_ops = 3           # (is_push, valid, payload)
    n_disp_outs = 2     # (pos, matched)
    extra_fill = (-1,)  # the ticket/bound request column
    local_overflow = True  # a slot's depth runs out at commit, per shard

    TAG_PUSH = TAG_PUT
    TAG_POP = TAG_GET

    def __init__(self, n_shards: int, cap: int, W: int, D: int):
        self.n_shards = n_shards
        self.cap = cap
        self.W = W
        self.D = D
        self.junk = cap
        self.window_capacity = n_shards * cap * D

    def split(self, state):
        """Split state into its (interval carry, store) halves."""
        return (state.last, state.ticket), (state.vals, state.ticks)

    def merge(self, carry, store):
        """Reassemble the full state from (carry, store) halves."""
        return DeviceStackState(carry[0], carry[1], store[0], store[1])

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3: one stack-scan launch over the whole flat wave (its
        op bits gathered on a multi-process runtime), then owners, slots
        and the ticket/bound column as this process's ``[n_local, L]``."""
        is_push_l, valid_l, payload = ops
        n, cap = self.n_shards, self.cap
        is_push, valid = self.gather_ops(is_push_l, valid_l)
        pos, tick, matched, new_last, new_ticket = stack_scan(
            is_push, valid, carry[0], carry[1])
        p2, m2 = self.local(pos), self.local(matched)
        e2 = is_push_l.view(p2.shape)
        owner = torch.where(m2, torch.remainder(p2, n), -1).to(torch.int32)
        slot = torch.where(
            m2, torch.remainder(torch.div(p2, n, rounding_mode="floor"),
                                cap), cap).to(torch.int32)
        tag = torch.where(m2 & e2, self.TAG_PUSH,
                          torch.where(m2 & ~e2, self.TAG_POP, TAG_INACTIVE))
        # capacity is a commit-time check (a slot's D entries run out)
        return Dispatch(owner, slot, tag.to(torch.int32), (self.local(tick),),
                        payload.reshape(*p2.shape, self.W), m2, m2 & ~e2,
                        (p2.reshape(-1), m2.reshape(-1)),
                        (new_last, new_ticket),
                        torch.zeros((), dtype=torch.bool, device=pos.device),
                        ())

    def commit(self, store, recv):
        """Stage 4 on every shard at once, in place: PUSH rows insert into
        a free depth entry of their slot, then each POP takes the largest
        ticket at its slot not above its bound.

        recv: ``[n_dst, n_src, L, 3+W]`` rows ``slot ‖ ticket/bound ‖ tag ‖
        payload``.  Inactive rows point at the junk slot ``cap`` and never
        insert; the scatters write the junk slot's own empty values there
        (ticket -1, payload 0), so duplicate indices, which only the junk
        slot receives, all write the same thing.  Returns (store, reply
        ``[n_dst, n_src, L, 1+W]`` ``ok ‖ value``, slot overflow: 0-d bool,
        one ``.any()`` over this process's shards, no host read).
        """
        cap, W, D = self.cap, self.W, self.D
        sv, stk = store
        n = sv.shape[0]
        dev = sv.device
        r_slot, r_tb, r_tag = recv[..., 0], recv[..., 1], recv[..., 2]

        # ---- PUSH inserts ----
        is_push_r = r_tag == self.TAG_PUSH
        rs = torch.where(is_push_r, r_slot, cap).reshape(n, -1)
        rt = torch.where(is_push_r, r_tb, -1).reshape(n, -1)
        # rank within the same slot, per destination shard: a stable sort
        # along each shard's row keeps the reference's arrival order
        rs, order = torch.sort(rs, dim=1, stable=True)
        rt = rt.gather(1, order)
        rv = recv[..., 3:].reshape(n, -1, W).gather(
            1, order[..., None].expand(-1, -1, W))
        R = rs.shape[1]
        idx = torch.arange(R, device=dev).expand(n, R)
        same = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                          rs[:, 1:] == rs[:, :-1]], 1)
        run_start = torch.cummax(torch.where(same, -1, idx), dim=1).values
        rank = idx - run_start
        shard = torch.arange(n, device=dev)[:, None]
        free = stk[shard, rs] < 0                            # [n, R, D]
        # each arrival takes the rank-th free entry of its slot.  The
        # free entries before depth d are counted in a loop over the D
        # depths: a cumsum along the length-D last axis is a slow CUDA
        # scan (456 of 530 device-ms of a 64-shard burst on an H100)
        pick = torch.empty_like(free)
        before = torch.zeros_like(rank)
        for d in range(D):
            pick[..., d] = free[..., d] & (before == rank)
            before = before + free[..., d]
        # argmax rejects bool: take the first True of an int8 copy
        depth = torch.argmax(pick.to(torch.int8), -1)
        ok_ins = pick.any(-1) & (rt >= 0) & (rs < cap)
        slot_i = torch.where(ok_ins, rs, cap)
        dep_i = torch.where(ok_ins, depth, D - 1)
        stk[shard, slot_i, dep_i] = torch.where(ok_ins, rt, -1).to(
            torch.int32)
        sv[shard, slot_i, dep_i] = torch.where(ok_ins[..., None], rv, 0).to(
            torch.int32)
        slot_overflow = ((rt >= 0) & (rs < cap) & ~ok_ins).any()

        # ---- POP picks: the largest ticket <= bound at the slot ----
        is_pop_r = r_tag == self.TAG_POP
        q_slot = torch.where(is_pop_r, r_slot, cap).long()   # [n, n, L]
        q_bound = torch.where(is_pop_r, r_tb, -1)
        shard3 = torch.arange(n, device=dev)[:, None, None]
        cand = stk[shard3, q_slot]                            # [n, n, L, D]
        score = torch.where((cand >= 0) & (cand <= q_bound[..., None]),
                            cand, -1)
        best, d_pick = score.max(-1)
        got = best >= 0
        res_vals = sv[shard3, q_slot, d_pick]                 # [n, n, L, W]
        # remove the picked entries (unique per pop: tickets are unique)
        # a device-side -1: a Python scalar set through tensor indices is
        # copied to the device from the host, a host sync
        stk.index_put_((shard3, torch.where(got, q_slot, cap),
                        torch.where(got, d_pick, D - 1)), stk.new_full((), -1))
        reply = torch.cat([got.to(torch.int32)[..., None], res_vals], -1)
        return (sv, stk), reply, slot_overflow

    def zero_outs(self, nL: int, device) -> tuple:
        """All-invalid per-op dispatch outputs (pipeline priming)."""
        return (torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.zeros((nL,), dtype=torch.bool, device=device))

    def occupancy(self, carry):
        """The stack's one window, ``[1, last]``: its occupancy ``[1]``."""
        return carry[0].reshape(1)


class DeviceStack:
    """Distributed LIFO (paper Sec. VI) over ``n_shards`` shards on one
    device.

    Stage 4 uses the same two-exchange layout as :class:`DeviceQueue`
    (request ``slot ‖ ticket/bound ‖ tag ‖ payload``, reply ``ok ‖
    value``) through the shared :class:`WaveEngine`.

    Args:
      n_shards, cap, payload_width, ops_per_shard: as :class:`DeviceQueue`.
      slot_depth: D, the (ticket, payload) entries per store slot.
      pipelined, metrics, metrics_ring, runtime, shards, device: as
        :class:`DeviceQueue`.  On a multi-process runtime the overflow
        output is this process's shards' (``runtime.host_reduce`` or-s
        it over the processes).
    """

    TAG_PUSH = LifoDiscipline.TAG_PUSH
    TAG_POP = LifoDiscipline.TAG_POP

    def __init__(self, n_shards: int, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 slot_depth: int = 4, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 runtime=None, shards=None, device=None):
        self.runtime = _make_runtime(n_shards, runtime, device,
                                     "DeviceStack")
        self.device = self.runtime.device
        self.n_shards = n_shards
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.D = slot_depth
        self.pipelined = pipelined
        self.metrics = bool(metrics)
        self.engine = WaveEngine(
            n_shards, LifoDiscipline(n_shards, cap, payload_width,
                                     slot_depth),
            self.runtime, shards=shards, pipelined=pipelined, metrics=metrics,
            metrics_ring=metrics_ring)
        self.disc = self.engine.disc
        self.shards, self.n_local = self.engine.shards, self.engine.n_local

    def init_state(self) -> DeviceStackState:
        """An empty stack on this structure's device (this process's
        shards' store rows)."""
        n, cap, W, D, dev = self.n_local, self.cap, self.W, self.D, \
            self.device
        return DeviceStackState(
            last=torch.tensor(0, dtype=torch.int32, device=dev),
            ticket=torch.tensor(0, dtype=torch.int32, device=dev),
            vals=torch.zeros((n, cap + 1, D, W), dtype=torch.int32,
                             device=dev),
            ticks=torch.full((n, cap + 1, D), -1, dtype=torch.int32,
                             device=dev))

    def step(self, state: DeviceStackState, is_push: torch.Tensor,
             valid: torch.Tensor, payload: torch.Tensor):
        """One wave; the store of ``state`` is updated in place.  Returns
        (new_state, positions, matched, pop_vals, pop_ok, overflow)."""
        return self.engine.step(state, is_push, valid, payload)

    def run_waves(self, state: DeviceStackState, is_push: torch.Tensor,
                  valid: torch.Tensor, payload: torch.Tensor):
        """K pre-staged push/pop waves (``[K, n_shards * L]``), no host
        sync between them; the store of ``state`` is updated in place."""
        return self.engine.run_waves(state, is_push, valid, payload)

    def drain_metrics(self, *, reset: bool = False) -> list:
        """Burst-boundary Wavescope drain (empty when metrics are off)."""
        return self.engine.drain_metrics(reset=reset)
