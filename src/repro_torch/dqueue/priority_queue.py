"""Device-resident P-tier priority queue on the fused Stage-4 wave path.

Counterpart of ``repro/dqueue/priority_queue.py``.  Skeap
(arXiv:1805.03472) in its constant-priority regime is P independent
SKUEUE position intervals tie-broken by tier.  The ring store gains one
round-robin slot window per tier: tier ``p``'s position ``q`` lives on
shard ``q % n_shards`` at slot ``p * cap + (q // n_shards) % cap``, and a
wave still costs two exchanges (K+1 per pipelined K-wave burst).

Only the dispatch differs from FIFO; the commit is the shared dense-ring
rewrite (:func:`~.wave_engine.ring_commit`):

* enqueues get per-tier FIFO positions from ONE launch of the tiered
  sweep kernel (``kernels.segscan.make_tier_scan``) over the whole flat
  wave: on one process straight from the wave, on a multi-process
  runtime after ONE ``runtime.gather`` of the reference's int32
  descriptor ``tier·4 + 2·is_enq + valid``; every process then runs the
  same sweep and keeps its own shards' rows, so the tier windows are
  replicated;
* the wave's dequeues drain the priority-ordered pool highest tier first:
  the d-th dequeue takes the d-th best element (strict mode, prefix
  arithmetic at full width);
* ``relaxation=k`` lets a dequeue take a locally owned head up to k tiers
  below the best one.  That resolution is sequential over the wave's
  dequeues: one launch of the relaxed kernel a wave
  (``kernels.relaxed``), with no host read, in every process over the
  same gathered wave (so ``n_relaxed`` is the same in each).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.scan_queue import priority_queue_scan
from ..kernels.segscan import make_tier_scan
from .device_queue import _make_runtime
from .elastic import _MultiWindowElastic
from .wave_engine import (TAG_GET, TAG_INACTIVE, TAG_PUT, Discipline,
                          Dispatch, WaveEngine, post_enqueue_peak_overflow,
                          ring_commit)


class PriorityQueueState(NamedTuple):
    """P-tier queue state: per-tier ``[firsts, lasts]`` live windows
    (``[P]`` int32 device tensors) plus the ring store, one slot window per
    tier (``store_vals [n_shards, P*cap+1, W]`` int32, ``store_full
    [n_shards, P*cap+1]`` bool; the last slot is the junk slot)."""

    firsts: torch.Tensor
    lasts: torch.Tensor
    store_vals: torch.Tensor
    store_full: torch.Tensor

    @property
    def sizes(self) -> torch.Tensor:
        """Per-tier occupancy ``[P]`` (a device tensor)."""
        return self.lasts - self.firsts + 1


class PriorityDiscipline(Discipline):
    """Skeap constant-priority order: the tiered enqueue sweep plus the
    in-wave batch-DeleteMin over the shared dense-ring store."""

    n_ops = 4           # (is_enq, valid, prio, payload)
    n_disp_outs = 3     # (tier, pos, matched)
    n_aux = 1           # n_relaxed

    def __init__(self, n_shards: int, n_prios: int, cap: int, W: int,
                 relaxation: int):
        self.n_shards = n_shards
        self.n_prios = n_prios
        self.cap = cap
        self.W = W
        self.relaxation = relaxation
        self.junk = n_prios * cap
        self.n_windows = n_prios
        self.window_capacity = n_shards * cap
        self._tier_scan = make_tier_scan(n_prios)
        self._shard_of: Optional[torch.Tensor] = None

    def split(self, state):
        """Split state into its (interval carry, store) halves."""
        return (state.firsts, state.lasts), (state.store_vals,
                                             state.store_full)

    def merge(self, carry, store):
        """Reassemble the full state from (carry, store) halves."""
        return PriorityQueueState(carry[0], carry[1], store[0], store[1])

    def _shards_of(self, nL: int, device) -> torch.Tensor:
        """The issuing shard (index in the active order) of each op of
        the whole flat wave, made once."""
        so = self._shard_of
        if so is None or so.shape[0] != nL or so.device != device:
            so = torch.div(torch.arange(nL, dtype=torch.int32, device=device),
                           nL // self.n_shards, rounding_mode="floor")
            self._shard_of = so
        return so

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3: one tiered sweep (and, relaxed, one relaxed
        resolution) over the whole flat wave, its descriptors gathered on
        a multi-process runtime, then owners and slots as this process's
        ``[n_local, L]`` rows."""
        is_enq_l, valid_l, prio_l, payload = ops
        firsts, lasts = carry
        n, cap = self.n_shards, self.cap
        is_enq, valid, prio = self.gather_ops(is_enq_l, valid_l, prio_l)
        shard_of = (self._shards_of(is_enq.shape[0], is_enq.device)
                    if self.relaxation > 0 else None)
        tier, pos, matched, new_firsts, new_lasts, n_relaxed = (
            priority_queue_scan(is_enq, prio, valid, firsts, lasts,
                                n_prios=self.n_prios,
                                relaxation=self.relaxation,
                                shard_of=shard_of, n_shards=n,
                                tier_scan=self._tier_scan))
        t2, p2, m2 = (self.local(x) for x in (tier, pos, matched))
        e2 = is_enq_l.view(p2.shape)
        owner = torch.where(m2, torch.remainder(p2, n), -1).to(torch.int32)
        slot = torch.where(
            m2, t2 * cap + torch.remainder(
                torch.div(p2, n, rounding_mode="floor"), cap),
            self.junk).to(torch.int32)
        tag = torch.where(m2 & e2, TAG_PUT,
                          torch.where(m2 & ~e2, TAG_GET, TAG_INACTIVE))
        # capacity holds per tier (each tier owns its own slot window)
        ovf = post_enqueue_peak_overflow(firsts, new_lasts, n * cap)
        return Dispatch(owner, slot, tag.to(torch.int32), (),
                        payload.reshape(*p2.shape, self.W), m2, m2 & ~e2,
                        (t2.reshape(-1), p2.reshape(-1), m2.reshape(-1)),
                        (new_firsts, new_lasts), ovf, (n_relaxed,))

    def commit(self, store, recv):
        """Stage 4: apply each shard's routed requests to its store."""
        return ring_commit(store, recv, self.junk, self.W)

    def zero_outs(self, nL: int, device) -> tuple:
        """All-invalid per-op dispatch outputs (pipeline priming)."""
        return (torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.zeros((nL,), dtype=torch.bool, device=device))

    def zero_aux(self, device) -> tuple:
        """A zero relaxed-serve count (pipeline priming)."""
        return (torch.zeros((), dtype=torch.int32, device=device),)

    def occupancy(self, carry):
        """Per-window occupancy ``[n_windows]`` from the carry."""
        return carry[1] - carry[0] + 1


class DevicePriorityQueue:
    """Distributed constant-priority queue over ``n_shards`` shards.

    Args:
      n_shards: shards; n_prios: tiers P (0 = most urgent); cap: slots per
        shard PER TIER; payload_width: int32 words per element;
        ops_per_shard: wave width L.
      relaxation: 0 = strict priority order; k > 0 lets a dequeue take a
        locally owned head up to k tiers below the best non-empty tier.
      pipelined, runtime, shards, device: as
        :class:`~repro_torch.dqueue.DeviceQueue` (on a multi-process
        runtime the state holds this process's shards' store rows, and
        ops and per-op outputs are their ``[n_local * L]`` rows).
      metrics, metrics_ring: a Wavescope row per wave into a device
        ring, as :class:`~repro_torch.dqueue.DeviceQueue`.
    """

    def __init__(self, n_shards: int, n_prios: int = 2, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 relaxation: int = 0, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 runtime=None, shards=None, device=None):
        if n_prios < 1:
            raise ValueError("need at least one priority tier")
        self.runtime = _make_runtime(n_shards, runtime, device,
                                     "DevicePriorityQueue")
        self.device = self.runtime.device
        self.n_shards = n_shards
        self.n_prios = n_prios
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.relaxation = relaxation
        self.pipelined = pipelined
        self.metrics = bool(metrics)
        self.engine = WaveEngine(
            n_shards, PriorityDiscipline(n_shards, n_prios, cap,
                                         payload_width, relaxation),
            self.runtime, shards=shards, pipelined=pipelined,
            metrics=metrics, metrics_ring=metrics_ring)
        self.disc = self.engine.disc
        self.shards, self.n_local = self.engine.shards, self.engine.n_local

    def init_state(self) -> PriorityQueueState:
        """An empty queue on this structure's device (this process's
        shards' store rows)."""
        n, cap, W, P_, dev = (self.n_local, self.cap, self.W, self.n_prios,
                              self.device)
        return PriorityQueueState(
            firsts=torch.zeros(P_, dtype=torch.int32, device=dev),
            lasts=torch.full((P_,), -1, dtype=torch.int32, device=dev),
            store_vals=torch.zeros((n, P_ * cap + 1, W), dtype=torch.int32,
                                   device=dev),
            store_full=torch.zeros((n, P_ * cap + 1), dtype=torch.bool,
                                   device=dev))

    def step(self, state: PriorityQueueState, is_enq, valid, prio, payload):
        """One global wave; the store of ``state`` is updated in place.

        is_enq/valid: [n_shards * L] bool; prio: [n_shards * L] int32 in
        [0, n_prios) (ignored for dequeues); payload: [n_shards * L, W].
        Returns (new_state, tier, pos, matched, deq_vals, deq_ok, overflow,
        n_relaxed); tier/pos are -1/⊥ for unmatched ops.
        """
        return self.engine.step(state, is_enq, valid, prio, payload)

    def run_waves(self, state: PriorityQueueState, is_enq, valid, prio,
                  payload):
        """K pre-staged waves (``[K, n_shards * L]``; payload ``[K, ...,
        W]``), no host sync between them; the store of
        ``state`` is updated in place.  Outputs are ``[K]``-stacked."""
        return self.engine.run_waves(state, is_enq, valid, prio, payload)

    def drain_metrics(self, *, reset: bool = False) -> list:
        """Burst-boundary Wavescope drain (empty when metrics are off)."""
        return self.engine.drain_metrics(reset=reset)


class ElasticDevicePriorityQueue(_MultiWindowElastic):
    """P-tier priority queue whose shard count is a runtime variable.

    Owns its state like :class:`~.elastic.ElasticDeviceQueue`; ``grow`` /
    ``shrink`` / ``resize`` re-materialize every tier window with ONE
    packed migration exchange.

    Args:
      n_shards, cap (per tier), payload_width, ops_per_shard, pool_size,
      runtime, device, pipelined, metrics, metrics_ring, flight_k: as
      :class:`~.elastic.ElasticDeviceQueue`.
      n_prios, relaxation: as :class:`DevicePriorityQueue`.
    """

    _kind = "pqueue"

    @property
    def _n_windows(self) -> int:
        return self.n_prios

    def __init__(self, n_shards: int, *, n_prios: int = 2,
                 relaxation: int = 0, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 pool_size: Optional[int] = None, runtime=None, device=None,
                 pipelined: bool = True, metrics: bool = False,
                 metrics_ring: int = 64, flight_k: int = 16):
        self.n_prios = n_prios
        self.relaxation = relaxation
        super().__init__(n_shards, cap=cap, payload_width=payload_width,
                         ops_per_shard=ops_per_shard, pool_size=pool_size,
                         runtime=runtime, device=device,
                         pipelined=pipelined, metrics=metrics,
                         metrics_ring=metrics_ring, flight_k=flight_k)

    def _make_inner(self, shards: list):
        return DevicePriorityQueue(len(shards), n_prios=self.n_prios,
                                   cap=self.cap,
                                   payload_width=self.W,
                                   ops_per_shard=self.L,
                                   relaxation=self.relaxation,
                                   pipelined=self.pipelined,
                                   metrics=self.metrics,
                                   metrics_ring=self.metrics_ring,
                                   runtime=self.runtime, shards=shards)

    # ------------------------------------------------------------ waves ----
    def step(self, is_enq, valid, prio, payload):
        """One wave on the current shards.  Returns (tier, pos, matched,
        deq_vals, deq_ok, overflow, n_relaxed); raises
        :class:`~.errors.QueueOverflowError` when the wave overflowed a
        tier window."""
        return self._drive(self.inner.step, False,
                           (is_enq, valid, prio, payload))

    def run_waves(self, is_enq, valid, prio, payload):
        """K pre-staged waves (shapes [K, n_shards * L]).  Raises
        :class:`~.errors.QueueOverflowError` on tier overflow."""
        return self._drive(self.inner.run_waves, True,
                           (is_enq, valid, prio, payload))

    # -------------------------------------------------------- migration ----
    def _unpack(self, state):
        return state.firsts, state.lasts, state.store_vals, state.store_full

    def _pack(self, a, b, X, Y):
        return PriorityQueueState(a, b, X, Y)

    def _layout(self) -> dict:
        return {**super()._layout(), "P": self.n_prios,
                "relaxation": self.relaxation}

    @classmethod
    def _layout_kwargs(cls, lay: dict) -> dict:
        return {**super()._layout_kwargs(lay), "n_prios": lay["P"],
                "relaxation": lay.get("relaxation", 0)}
