"""Device-resident arbitrary-key queue: Seap on the fused wave path.

Counterpart of ``repro/dqueue/seap_queue.py``.  Seap (arXiv:1805.03472,
second half) extends Skeap's constant tiers to arbitrary int32 keys; on
the wave engine its search structure collapses to a two-level bucket
directory:

* the ring store has one round-robin slot window per bucket id, exactly
  the priority queue's tier windows (bucket ``b``'s position ``q`` lives
  on shard ``q % n_shards`` at slot ``b * cap + (q // n_shards) % cap``),
  so a wave still costs two exchanges (K+1 per pipelined K-wave burst);
* a boundary table ``(lo[B], active[B])`` maps a key to the active bucket
  with the largest boundary ``lo <= key``;
* enqueues get per-bucket FIFO positions from ONE launch of the tiered
  sweep kernel with tier := bucket over the whole flat wave: on one
  process straight from the wave, on a multi-process runtime after ONE
  ``runtime.gather`` of the reference's ``[n_local, L, 2]`` int32
  descriptor (code ‖ key); every process then runs the same lookup,
  sweep and rebalance and keeps its own shards' rows, so the directory
  and the bucket windows are replicated;
* the wave's dequeues drain the directory in ascending boundary order,
  FIFO inside a bucket (Skeap's batch-DeleteMin over the sorted
  directory);
* the directory is rebalanced in the wave by a split/merge rule on
  device tensors that never moves an element.  Order is therefore
  bucket-granular: an inversion is bounded by the key range its bucket
  held when the element entered.

:class:`ElasticDeviceSeapQueue` moves every bucket window with one packed
migration exchange; the directory passes through untouched.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.scan_queue import seap_queue_scan
from ..core.seap import INT32_MAX, INT32_MIN, check_seed_bounds
from ..kernels.segscan import make_tier_scan
from .device_queue import _make_runtime
from .elastic import _MultiWindowElastic
from .wave_engine import (TAG_GET, TAG_INACTIVE, TAG_PUT, Discipline,
                          Dispatch, WaveEngine, post_enqueue_peak_overflow,
                          ring_commit)


class SeapQueueState(NamedTuple):
    """Seap queue state: per-bucket ``[firsts, lasts]`` windows, the bucket
    directory (``lo`` boundaries, ``active`` membership, the observed key
    range ``key_lo``/``key_hi``; ``[B]`` and 0-d device tensors) and the
    ring store, one slot window per bucket (``store_vals [n_shards,
    B*cap+1, W]`` int32, ``store_full [n_shards, B*cap+1]`` bool; the last
    slot is the junk slot)."""

    firsts: torch.Tensor      # [B] int32
    lasts: torch.Tensor       # [B] int32
    lo: torch.Tensor          # [B] int32 bucket key boundaries
    active: torch.Tensor      # [B] bool directory membership
    key_lo: torch.Tensor      # 0-d int32: least key ever enqueued
    key_hi: torch.Tensor      # 0-d int32: greatest key ever enqueued
    store_vals: torch.Tensor
    store_full: torch.Tensor

    @property
    def sizes(self) -> torch.Tensor:
        """Per-bucket occupancy ``[B]`` (a device tensor)."""
        return self.lasts - self.firsts + 1


class SeapDiscipline(Discipline):
    """Seap arbitrary-key order: directory lookup, the tiered enqueue
    sweep over buckets and the boundary-ordered batch-DeleteMin over the
    shared dense-ring store, with the in-wave directory rebalance."""

    n_ops = 4           # (is_enq, valid, key, payload)
    n_disp_outs = 3     # (bucket, pos, matched)
    n_aux = 1           # n_active (directory size after the rebalance)

    def __init__(self, n_shards: int, n_buckets: int, cap: int, W: int,
                 split_occupancy: int):
        self.n_shards = n_shards
        self.n_buckets = n_buckets
        self.cap = cap
        self.W = W
        self.split_occupancy = split_occupancy
        self.junk = n_buckets * cap
        self.n_windows = n_buckets
        self.window_capacity = n_shards * cap
        self._tier_scan = make_tier_scan(n_buckets)

    def split(self, state):
        """Split state into its (carry, store) halves."""
        return ((state.firsts, state.lasts, state.lo, state.active,
                 state.key_lo, state.key_hi),
                (state.store_vals, state.store_full))

    def merge(self, carry, store):
        """Reassemble the full state from (carry, store) halves."""
        return SeapQueueState(*carry, store[0], store[1])

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3: the directory lookup, one tiered sweep and the
        rebalance over the whole flat wave, its key descriptors gathered
        on a multi-process runtime, then owners and slots as this
        process's ``[n_local, L]`` rows.  Every process scans the same
        gathered keys, so the directory stays replicated."""
        is_enq_l, valid_l, key_l, payload = ops
        n, cap = self.n_shards, self.cap
        is_enq, valid, key = self.gather_ops(is_enq_l, valid_l, key_l,
                                             key_column=True)
        (bucket, pos, matched, new_firsts, new_lasts, new_lo, new_active,
         new_key_lo, new_key_hi, n_active) = seap_queue_scan(
            is_enq, key, valid, *carry, n_buckets=self.n_buckets,
            split_occupancy=self.split_occupancy, tier_scan=self._tier_scan)
        b2, p2, m2 = (self.local(x) for x in (bucket, pos, matched))
        e2 = is_enq_l.view(p2.shape)
        owner = torch.where(m2, torch.remainder(p2, n), -1).to(torch.int32)
        slot = torch.where(
            m2, b2 * cap + torch.remainder(
                torch.div(p2, n, rounding_mode="floor"), cap),
            self.junk).to(torch.int32)
        tag = torch.where(m2 & e2, TAG_PUT,
                          torch.where(m2 & ~e2, TAG_GET, TAG_INACTIVE))
        # capacity holds per bucket (each bucket owns its own slot window)
        ovf = post_enqueue_peak_overflow(carry[0], new_lasts, n * cap)
        return Dispatch(owner, slot, tag.to(torch.int32), (),
                        payload.reshape(*p2.shape, self.W), m2, m2 & ~e2,
                        (b2.reshape(-1), p2.reshape(-1), m2.reshape(-1)),
                        (new_firsts, new_lasts, new_lo, new_active,
                         new_key_lo, new_key_hi), ovf, (n_active,))

    def commit(self, store, recv):
        """Stage 4: apply each shard's routed requests to its store."""
        return ring_commit(store, recv, self.junk, self.W)

    def zero_outs(self, nL: int, device) -> tuple:
        """All-invalid per-op dispatch outputs (pipeline priming)."""
        return (torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.zeros((nL,), dtype=torch.bool, device=device))

    def zero_aux(self, device) -> tuple:
        """A zero directory size (pipeline priming)."""
        return (torch.zeros((), dtype=torch.int32, device=device),)

    def occupancy(self, carry):
        """Per-window occupancy ``[n_windows]`` from the carry."""
        return carry[1] - carry[0] + 1


def default_split_occupancy(n_shards: int, cap: int) -> int:
    """Split a bucket when it passes 3/4 of its window (headroom for the
    wave in flight while the upper half diverts to the new id)."""
    return max(1, (3 * n_shards * cap) // 4)


class DeviceSeapQueue:
    """Distributed arbitrary-key queue over ``n_shards`` shards.

    Args:
      n_shards: shards; n_buckets: directory capacity B (bucket ids, each
        owning a slot window); cap: slots per shard PER BUCKET;
        payload_width: int32 words per element; ops_per_shard: wave
        width L.
      split_occupancy: occupancy above which a bucket's key range is
        halved into a free id (default: 3/4 of a bucket window).
      seed_bounds: optional warm-start boundaries (strictly increasing
        ints, see :func:`repro_torch.core.seap.check_seed_bounds`).
      pipelined, runtime, shards, device: as
        :class:`~repro_torch.dqueue.DeviceQueue` (on a multi-process
        runtime the state holds this process's shards' store rows, and
        ops and per-op outputs are their ``[n_local * L]`` rows).
      metrics, metrics_ring: a Wavescope row per wave into a device
        ring, as :class:`~repro_torch.dqueue.DeviceQueue`.
    """

    def __init__(self, n_shards: int, n_buckets: int = 8, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 split_occupancy: Optional[int] = None, seed_bounds=None,
                 pipelined: bool = True, metrics: bool = False,
                 metrics_ring: int = 64, runtime=None, shards=None,
                 device=None):
        if n_buckets < 1:
            raise ValueError("need at least one bucket")
        if split_occupancy is None:
            split_occupancy = default_split_occupancy(n_shards, cap)
        if split_occupancy < 1:
            raise ValueError("split_occupancy must be >= 1")
        self.seed_bounds = check_seed_bounds(seed_bounds, n_buckets)
        self.runtime = _make_runtime(n_shards, runtime, device,
                                     "DeviceSeapQueue")
        self.device = self.runtime.device
        self.n_shards = n_shards
        self.n_buckets = n_buckets
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.split_occupancy = split_occupancy
        self.pipelined = pipelined
        self.metrics = bool(metrics)
        self.engine = WaveEngine(
            n_shards, SeapDiscipline(n_shards, n_buckets, cap,
                                     payload_width, split_occupancy),
            self.runtime, shards=shards, pipelined=pipelined,
            metrics=metrics, metrics_ring=metrics_ring)
        self.disc = self.engine.disc
        self.shards, self.n_local = self.engine.shards, self.engine.n_local

    def init_state(self) -> SeapQueueState:
        """An empty queue on this structure's device (this process's
        shards' store rows), its directory the root plus the seed
        bounds."""
        n, cap, W, B, dev = (self.n_local, self.cap, self.W, self.n_buckets,
                             self.device)
        ns = len(self.seed_bounds)
        lo = [INT32_MIN] + self.seed_bounds + [INT32_MAX] * (B - 1 - ns)
        active = [True] * (1 + ns) + [False] * (B - 1 - ns)

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)
        return SeapQueueState(
            firsts=torch.zeros(B, dtype=torch.int32, device=dev),
            lasts=torch.full((B,), -1, dtype=torch.int32, device=dev),
            lo=i32(lo),
            active=torch.tensor(active, dtype=torch.bool, device=dev),
            key_lo=i32(INT32_MAX), key_hi=i32(INT32_MIN),
            store_vals=torch.zeros((n, B * cap + 1, W), dtype=torch.int32,
                                   device=dev),
            store_full=torch.zeros((n, B * cap + 1), dtype=torch.bool,
                                   device=dev))

    def step(self, state: SeapQueueState, is_enq, valid, key, payload):
        """One global wave; the store of ``state`` is updated in place.

        is_enq/valid: [n_shards * L] bool; key: [n_shards * L] int32
        (any int32, smaller = more urgent; ignored for dequeues); payload:
        [n_shards * L, W].  Returns (new_state, bucket, pos, matched,
        deq_vals, deq_ok, overflow, n_active); bucket/pos are -1/⊥ for
        unmatched ops, ``n_active`` the directory size after the wave.
        """
        return self.engine.step(state, is_enq, valid, key, payload)

    def run_waves(self, state: SeapQueueState, is_enq, valid, key, payload):
        """K pre-staged waves (``[K, n_shards * L]``; payload ``[K, ...,
        W]``), no host sync between them; the store of ``state`` is
        updated in place.  Outputs are ``[K]``-stacked."""
        return self.engine.run_waves(state, is_enq, valid, key, payload)

    def drain_metrics(self, *, reset: bool = False) -> list:
        """Burst-boundary Wavescope drain (empty when metrics are off)."""
        return self.engine.drain_metrics(reset=reset)


class ElasticDeviceSeapQueue(_MultiWindowElastic):
    """Arbitrary-key queue whose shard count is a runtime variable.

    Owns its state like :class:`~.elastic.ElasticDeviceQueue`; ``grow`` /
    ``shrink`` / ``resize`` re-materialize every bucket window with ONE
    packed migration exchange, and the directory passes through it
    untouched.

    Args:
      n_shards, cap (per bucket), payload_width, ops_per_shard, pool_size,
      runtime, device, pipelined, metrics, metrics_ring, flight_k: as
      :class:`~.elastic.ElasticDeviceQueue`.
      n_buckets, split_occupancy, seed_bounds: as
      :class:`DeviceSeapQueue` (the split threshold defaults from the
      initial shard count and stays fixed across resizes).
    """

    _kind = "squeue"

    @property
    def _n_windows(self) -> int:
        return self.n_buckets

    def __init__(self, n_shards: int, *, n_buckets: int = 8,
                 split_occupancy: Optional[int] = None, seed_bounds=None,
                 cap: int = 1024, payload_width: int = 4,
                 ops_per_shard: int = 64, pool_size: Optional[int] = None,
                 runtime=None, device=None, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 flight_k: int = 16):
        self.n_buckets = n_buckets
        if split_occupancy is None:
            split_occupancy = default_split_occupancy(n_shards, cap)
        self.split_occupancy = split_occupancy
        self.seed_bounds = check_seed_bounds(seed_bounds, n_buckets)
        super().__init__(n_shards, cap=cap, payload_width=payload_width,
                         ops_per_shard=ops_per_shard, pool_size=pool_size,
                         runtime=runtime, device=device,
                         pipelined=pipelined, metrics=metrics,
                         metrics_ring=metrics_ring, flight_k=flight_k)

    def _make_inner(self, shards: list):
        return DeviceSeapQueue(len(shards), n_buckets=self.n_buckets,
                               cap=self.cap,
                               payload_width=self.W, ops_per_shard=self.L,
                               split_occupancy=self.split_occupancy,
                               seed_bounds=self.seed_bounds,
                               pipelined=self.pipelined,
                               metrics=self.metrics,
                               metrics_ring=self.metrics_ring,
                               runtime=self.runtime, shards=shards)

    # ------------------------------------------------------------ waves ----
    def step(self, is_enq, valid, key, payload):
        """One wave on the current shards.  Returns (bucket, pos, matched,
        deq_vals, deq_ok, overflow, n_active); raises
        :class:`~.errors.QueueOverflowError` when the wave overflowed a
        bucket window."""
        return self._drive(self.inner.step, False,
                           (is_enq, valid, key, payload))

    def run_waves(self, is_enq, valid, key, payload):
        """K pre-staged waves (shapes [K, n_shards * L]).  Raises
        :class:`~.errors.QueueOverflowError` on bucket overflow."""
        return self._drive(self.inner.run_waves, True,
                           (is_enq, valid, key, payload))

    @property
    def n_active(self) -> int:
        """Active buckets in the directory (a host read)."""
        return int(self.state.active.sum())

    def directory(self) -> list:
        """Active ``(lo, bucket_id)`` entries in ascending key order (a
        host read)."""
        lo = self.runtime.to_host(self.state.lo)
        act = self.runtime.to_host(self.state.active)
        return sorted((int(lo[b]), b) for b in range(self.n_buckets)
                      if act[b])

    # -------------------------------------------------------- migration ----
    def _unpack(self, state):
        # the directory is not touched by the migration wave: keep it for
        # the new state
        self._mig_directory = (state.lo, state.active, state.key_lo,
                               state.key_hi)
        return state.firsts, state.lasts, state.store_vals, state.store_full

    def _pack(self, a, b, X, Y):
        directory, self._mig_directory = self._mig_directory, None
        return SeapQueueState(a, b, *directory, X, Y)

    def _layout(self) -> dict:
        return {**super()._layout(), "B": self.n_buckets,
                "split": self.split_occupancy, "seed": self.seed_bounds}

    @classmethod
    def _layout_kwargs(cls, lay: dict) -> dict:
        # the live directory (lo/active) restores from the state dict;
        # the seed only shapes a fresh init_state
        return {**super()._layout_kwargs(lay), "n_buckets": lay["B"],
                "split_occupancy": lay["split"],
                "seed_bounds": lay.get("seed") or None}
