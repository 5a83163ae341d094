"""Device-resident distributed FIFO: the FIFO discipline over the engine.

Counterpart of ``repro/dqueue/device_queue.py`` (FIFO part).  Position
``p`` lives on shard ``p % n_shards`` at slot ``(p // n_shards) % cap``: a
dense sharded ring buffer, here ``store_vals [n_shards, cap+1, W]`` on one
device with the extra slot as the junk row.  One ``step`` is one paper
wave: position assignment by the min-plus scan (Stages 1-3, the segscan
kernel over the flat shard-major wave), then PUT/GET through the
exchange seam (Stage 4), PUTs before GETs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.segscan import queue_scan
from ..runtime import LocalRuntime
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

    def split(self, state):
        """Split state into its (interval carry, store) halves."""
        return (state.first, state.last), (state.store_vals,
                                           state.store_full)

    def merge(self, carry, store):
        """Reassemble the full state from (carry, store) halves."""
        return DeviceQueueState(carry[0], carry[1], store[0], store[1])

    def dispatch(self, carry, ops) -> Dispatch:
        """Stages 1-3: one segscan over the flat wave, then owners and
        slots as ``[n_shards, L]`` rows."""
        is_enq, valid, payload = ops
        n = self.n_shards
        pos, matched, new_first, new_last = queue_scan(
            is_enq, valid, carry[0], carry[1])
        p2, m2 = pos.reshape(n, -1), matched.reshape(n, -1)
        e2 = is_enq.reshape(n, -1)
        owner = torch.where(m2, torch.remainder(p2, n), -1).to(torch.int32)
        slot = torch.where(
            m2, torch.remainder(torch.div(p2, n, rounding_mode="floor"),
                                self.cap), self.cap).to(torch.int32)
        tag = torch.where(m2 & e2, TAG_PUT,
                          torch.where(m2 & ~e2, TAG_GET, TAG_INACTIVE))
        ovf = post_enqueue_peak_overflow(carry[0], new_last,
                                         n * self.cap)
        return Dispatch(owner, slot, tag.to(torch.int32), (),
                        payload.reshape(n, -1, self.W), m2, m2 & ~e2,
                        (pos, matched), (new_first, new_last), ovf, ())

    def commit(self, store, recv):
        """Stage 4: apply each shard's routed requests to its store."""
        return ring_commit(store, recv, self.junk, self.W)

    def zero_outs(self, nL: int, device) -> tuple:
        """All-invalid per-op dispatch outputs (pipeline priming)."""
        return (torch.full((nL,), -1, dtype=torch.int32, device=device),
                torch.zeros((nL,), dtype=torch.bool, device=device))


class DeviceQueue:
    """Distributed FIFO over ``n_shards`` shards on one device.

    Args:
      n_shards: shards (the reference's mesh axis size).
      cap: slots per shard; payload_width: int32 words per element;
      ops_per_shard: wave width L.
      fused: must be True (the two-exchange engine path); the reference's
        five-collective seed path is not ported.
      pipelined: multi-wave bursts overlap wave k's dispatch with wave
        k-1's commit (K+1 exchanges); False keeps the sequential schedule.
        Results are identical either way.
      metrics: must be False (the device telemetry ring is not ported).
      runtime: a :class:`~repro_torch.runtime.LocalRuntime`; default one
        over ``n_shards`` shards on ``device``.
      device: where state and waves live; default CUDA (raises if absent).
    """

    def __init__(self, n_shards: int, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 fused: bool = True, pipelined: bool = True,
                 metrics: bool = False, runtime=None, device=None):
        if not fused:
            raise NotImplementedError(
                "DeviceQueue(fused=False): the five-exchange seed wave "
                "waits for a later slice (ROADMAP queue 1, item 3)")
        if metrics:
            raise NotImplementedError(
                "DeviceQueue(metrics=True): the Wavescope ring waits for a "
                "later slice (ROADMAP queue 1, item 11)")
        if runtime is None:
            runtime = LocalRuntime(n_shards, device=device)
        elif not isinstance(runtime, LocalRuntime):
            raise NotImplementedError(
                "only LocalRuntime is ported; the distributed and "
                "simulated runtimes wait (ROADMAP queue 1, item 5)")
        self.runtime = runtime
        self.device = runtime.device
        self.n_shards = n_shards
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.fused = True
        self.pipelined = pipelined
        self.metrics = False
        self.engine = WaveEngine(
            n_shards, FifoDiscipline(n_shards, cap, payload_width), runtime,
            pipelined=pipelined)

    def init_state(self) -> DeviceQueueState:
        """An empty queue on this structure's device."""
        n, cap, W, dev = self.n_shards, self.cap, self.W, self.device
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

        is_enq/valid: [n_shards * L] bool; payload: [n_shards * L, W] int32.
        Returns (new_state, positions, matched, deq_vals, deq_ok, overflow).
        """
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
        return self.engine.run_waves(state, is_enq, valid, payload)
