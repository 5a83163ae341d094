"""Elastic membership for the device path: live JOIN/LEAVE resharding.

Counterpart of ``repro/dqueue/elastic.py``: the FIFO queue, the LIFO stack
and the multi-window base of the priority queue.  Between bursts
the store is quiescent, and because positions are dense integers laid out
round-robin (position ``p`` on shard ``p % P`` at slot ``(p // P) % cap``)
the live positions are exactly ``[first, last]``: every shard recovers the
position each occupied slot holds without scanning.  One migration wave
then

1. recomputes each live element's owner ``p % P'`` and slot under the new
   shard count,
2. packs ``new_slot ‖ payload`` rows per destination and moves them with
   ONE exchange (``wave_engine.migrate_packed``), and
3. rewrites the receiving shards' stores; ``first``/``last`` pass through
   unchanged, so membership never disturbs the position order.

The migration runs over the larger of the two shard sets: a grow pads the
store with empty shards first, a shrink routes on the old set (every new
owner is a surviving row) and then drops the emptied rows.  All of it
stays on the device.  The paper's consistent-hashing balance for the same
live set is reported in the migration stats through the hash-route kernel.

The stack's live positions are ``[1, last]``; its migration moves every
(slot, depth) entry with its ticket, and distinct positions land on
distinct new slots, so (new slot, depth) addressing cannot collide.  A
multi-window structure (priority tiers) keeps one ``[first, last]`` window
per tier in its own slot range and moves every window in the same single
exchange.

``save``/``restore`` write and read the reference's checkpoint format
(the layout in the manifest); a restore at another shard count is a
restore at the saved count plus one migration wave.

On a multi-process runtime every process holds its own shards' store
rows and passes the same global host ops, of which it places its own
shards' rows.  The migration goes from the old shard list to the new
one: each process packs its old shards' live elements (every window's,
for the priority tiers and Seap buckets), the one exchange delivers them
to the processes that hold the new shards, and the moved count and lost
flag are summed over the processes at the host read.  The intervals
(and Seap's directory) are replicated.  ``save``/``restore`` stay on
one process, as in the reference, whose checkpointer reads every leaf
on the host (``repro/checkpoint/checkpointer.py:53``).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels.hash_route import hash_route
from ..obs.recorder import FlightRecorder
from ..obs.trace import span
from ..runtime import LocalRuntime, select_devices
from .device_queue import (DeviceQueue, DeviceQueueState, DeviceStack,
                           DeviceStackState, check_runtime)
from .errors import QueueOverflowError
from .wave_engine import (bucket_ladder, fanout_bound, migrate_packed,
                          pick_bucket_width, recover_positions,
                          rewrite_ring_store)

HASH_BALANCE_MAX_SIZE = 1 << 16  # skip the fidelity report for huge queues


class _ElasticBase:
    """Shared machinery: shard bookkeeping, the inner fixed-size queue per
    shard set, resizing, migration stats, the pressure API, telemetry
    and checkpoint save/restore."""

    _kind: str = "queue"

    def __init__(self, n_shards: int, *, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 pool_size: Optional[int] = None, runtime=None,
                 device=None, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 flight_k: int = 16):
        if runtime is None:
            runtime = LocalRuntime(pool_size or n_shards, device=device)
        else:
            check_runtime(runtime, type(self).__name__)
            if pool_size is not None or device is not None:
                raise ValueError("pass pool_size=/device= OR runtime=, not "
                                 "both (the runtime owns the shard pool)")
        self.runtime = runtime
        self._active = select_devices(runtime.pool(), n_shards)
        self.device = runtime.device
        self.cap = cap
        self.W = payload_width
        self.L = ops_per_shard
        self.pipelined = pipelined
        self.metrics = bool(metrics)
        self.metrics_ring = int(metrics_ring)
        self.recorder = FlightRecorder(flight_k)
        self._inner_cache: dict = {}
        self.inner = self._get_inner(self._active)
        self.state = self.inner.init_state()
        self.migrations: List[dict] = []

    def _get_inner(self, shards: list):
        """The fixed-size structure over ``shards``, cached per shard set
        as the reference caches one per mesh (so a telemetry ring's wave
        numbers restart on a new set, as there)."""
        key = tuple(d.id for d in shards)
        if key not in self._inner_cache:
            self._inner_cache[key] = self._make_inner(list(shards))
        return self._inner_cache[key]

    # ---------------------------------------------------------- overflow ---
    def _wave_capacity(self) -> int:
        """Elements one store window holds (the discipline's
        ``window_capacity``: ``n_shards * cap``, times ``D`` for the
        stack)."""
        return self.inner.disc.window_capacity

    def _occupancies(self) -> list:
        return [self.size]

    _overflow_detail: str = ""

    def _drain_telemetry(self) -> list:
        """Burst-boundary Wavescope drain into the flight recorder (the
        one host read of the telemetry; nothing with metrics off).
        Returns the freshly drained wave summaries."""
        eng = getattr(self.inner, "engine", None)
        if not self.metrics or eng is None or not eng.metrics:
            return []
        rows = eng.drain_metrics(reset=True)
        self.recorder.extend(rows)
        return rows

    def trajectory(self) -> list:
        """The flight recorder's last-K wave summaries, oldest first."""
        return self.recorder.trajectory()

    def _check_overflow(self, ovf) -> None:
        """Drain telemetry, then host-raise the wave's overflow flag (a 0-d
        or [K] bool tensor) as a :class:`~.errors.QueueOverflowError`
        carrying the flight recorder's trajectory.  Runs once per step or
        burst, so the recorder sees every wave.  A flag each process sets
        for its own shards (the stack's) is or-ed over the processes."""
        self._drain_telemetry()
        o = (self.runtime.host_reduce(ovf, "any")
             if self.inner.disc.local_overflow else self.runtime.to_host(ovf))
        if not bool(o.any()):
            return
        wave = int(np.flatnonzero(o)[0]) if o.ndim >= 1 else None
        raise QueueOverflowError(self._kind, self._wave_capacity(),
                                 self._occupancies(), wave=wave,
                                 detail=self._overflow_detail,
                                 trajectory=self.recorder.trajectory())

    # ------------------------------------------------------ pressure API ---
    def window_capacity(self) -> int:
        """Elements ONE store window holds under the current membership
        (``n_shards * cap``), a host int."""
        return self._wave_capacity()

    def occupancy(self) -> List[int]:
        """Committed post-burst occupancy per window, as host ints (reads
        the ``first``/``last`` scalars: a small device-to-host copy)."""
        return list(self._occupancies())

    def headroom(self) -> List[int]:
        """Free slots per window before the next enqueue overwrites data."""
        cap = self._wave_capacity()
        return [cap - o for o in self.occupancy()]

    def pressure(self) -> dict:
        """One-call snapshot: ``capacity``, ``occupancy``, ``headroom``,
        ``n_windows``, ``n_shards``, ``pool_size`` and ``utilization``
        (the hottest window's occupancy over capacity)."""
        cap = self._wave_capacity()
        occ = self.occupancy()
        return {
            "capacity": cap,
            "occupancy": occ,
            "headroom": [cap - o for o in occ],
            "n_windows": len(occ),
            "n_shards": self.n_shards,
            "pool_size": self.pool_size,
            "utilization": (max(occ) / cap) if cap else 1.0,
        }

    def bucket_widths(self) -> tuple:
        """Ascending per-shard wave widths ``{L/4, L/2, L}``."""
        return bucket_ladder(self.L)

    def pick_width(self, n_ops: int) -> int:
        """Smallest ladder width whose global wave fits ``n_ops``."""
        return pick_bucket_width(self.L, self.n_shards, n_ops)

    def _burst_span(self, K: int):
        self.runtime.on_burst(self._kind, int(K), self.n_shards,
                              width=self.L, payload_width=self.W,
                              pipelined=self.pipelined)
        return span(f"{self._kind}:burst", cat="wave", K=int(K),
                    n_shards=self.n_shards)

    def _place(self, x, lead: int = 0):
        return self.runtime.place(x, self._active, lead)

    def _drive(self, fn, multi: bool, ops) -> tuple:
        """Run the inner structure's ``step`` or ``run_waves`` (``fn``) on
        the placed ``ops`` (this process's shards' rows on a
        multi-process runtime), keep the new state, and raise the wave's
        overflow flag as :class:`~.errors.QueueOverflowError`.  Returns
        the outputs after the state.

        The burst span records at its close ``exchange_bytes``, the bytes
        this process passed to the runtime's exchange in the burst, and
        ``ops``, this process's op slots in the burst (K × its shards ×
        width), so that their ratio is per process on any runtime."""
        ops = [self._place(x, int(multi)) for x in ops]
        K = ops[0].shape[0] if multi else 1
        rt = self.runtime
        with self._burst_span(K) as sp:
            b0 = rt.exchange_bytes
            self.state, *out = fn(self.state, *ops)
            sp.set(exchange_bytes=rt.exchange_bytes - b0,
                   ops=K * ops[0].shape[int(multi)])
        self._check_overflow(out[self.inner.disc.n_disp_outs + 2])
        return tuple(out)

    # -------------------------------------------------------- membership ---
    @property
    def n_shards(self) -> int:
        """Current number of active shards."""
        return len(self._active)

    @property
    def pool_size(self) -> int:
        """Live shards available to this queue (active + spare)."""
        return self.runtime.pool_size

    @property
    def shards(self) -> list:
        """The active shard list, in shard-index order (what
        ``runtime.place`` and ``runtime.to_host`` take)."""
        return list(self._active)

    @property
    def device_ids(self) -> list:
        """Stable ids of the active shards, in shard-index order."""
        return [d.id for d in self._active]

    def grow(self, k: int = 1) -> dict:
        """JOIN: add ``k`` shards from the live pool (P -> P + k)."""
        if k < 1:
            raise ValueError("grow(k) needs k >= 1")
        active_ids = set(self.device_ids)
        spare = [d for d in self.runtime.pool() if d.id not in active_ids]
        if len(spare) < k:
            raise ValueError(f"cannot grow by {k}: only {len(spare)} spare "
                             f"shards in the pool")
        return self._rematerialize(self._active + spare[:k], kind="grow")

    def shrink(self, ids: Sequence[int]) -> dict:
        """Graceful LEAVE of the shards with indices ``ids``; the leaving
        shards take part in the migration wave."""
        ids = sorted(set(int(i) for i in ids))
        if not ids:
            raise ValueError("shrink(ids) needs at least one shard id")
        if ids[0] < 0 or ids[-1] >= self.n_shards:
            raise ValueError(f"shard ids {ids} out of range "
                             f"[0, {self.n_shards})")
        if len(ids) >= self.n_shards:
            raise ValueError("cannot shrink to zero shards")
        survivors = [d for i, d in enumerate(self._active) if i not in ids]
        return self._rematerialize(survivors, kind="shrink")

    def shrink_devices(self, dev_ids: Sequence[int], *,
                       quarantine: bool = False) -> dict:
        """Graceful LEAVE keyed by stable shard id; ``quarantine`` also
        marks them failed so no later :meth:`grow` picks them again."""
        ids = [int(i) for i in dev_ids]
        mine = self.device_ids
        missing = [i for i in ids if i not in mine]
        if missing:
            raise ValueError(f"shard id(s) {missing} are not active "
                             f"(active ids: {mine})")
        stats = self.shrink([mine.index(i) for i in ids])
        if quarantine:
            for i in ids:
                self.runtime.mark_failed(i)
        return stats

    def resize(self, n_new: int) -> dict:
        """Reshape to ``n_new`` shards (grow or shrink as needed)."""
        if n_new == self.n_shards:
            return {"kind": "noop", "P_from": self.n_shards,
                    "P_to": n_new, "moved": 0}
        if n_new > self.n_shards:
            return self.grow(n_new - self.n_shards)
        return self.shrink(range(n_new, self.n_shards))

    # ----------------------------------------------------- rematerialize ---
    def _rematerialize(self, new_active: list, kind: str) -> dict:
        """The migration, traced as ``migration:{kind}`` with three child
        spans: ``migration:plan`` (the capacity guard's host read and the
        state's unpacking), ``migration:wave`` (the packed exchange and
        the rewrite, timed as ``wave_s`` between two synchronisations)
        and ``migration:settle`` (the moved/lost read, the new state and
        inner structure, the hash-balance report).  ``host_s`` is the
        whole call less ``wave_s``."""
        P_old, P_new = self.n_shards, len(new_active)
        rt = self.runtime
        t_total = time.perf_counter()
        with span(f"migration:{kind}", cat="membership", kind=self._kind,
                  P_from=P_old, P_to=P_new):
            with span("migration:plan", cat="membership"):
                need = self._live_span()
                if need > P_new * self.cap:
                    raise ValueError(
                        f"cannot reshard to {P_new} shards: {need} live "
                        f"elements exceed the new capacity {P_new} * "
                        f"{self.cap}")
                a, b, X, Y = self._unpack(self.state)
                self.state = None         # let the old store go early
                old, new = self._active, list(new_active)
                n_ex = rt.n_exchanges
                rt.sync()
            with span("migration:wave", cat="membership"):
                t_wave = time.perf_counter()
                X, Y, moved, lost = self._migrate(a, b, X, Y, old, new)
                rt.sync()
                t_wave = time.perf_counter() - t_wave
            with span("migration:settle", cat="membership"):
                n_moved, n_lost = (int(v) for v in rt.host_reduce(
                    torch.stack([moved.to(torch.int64),
                                 lost.to(torch.int64)])))
                if n_lost:
                    raise RuntimeError("migration fanout overflow — "
                                       "internal bound violated, elements "
                                       "would have been dropped")
                self.state = self._pack(a, b, X, Y)
                self._active = new
                self.inner = self._get_inner(self._active)
                stats = {"kind": kind, "P_from": P_old, "P_to": P_new,
                         "moved": n_moved,
                         "bytes_moved": n_moved * self._entry_bytes,
                         "wave_s": t_wave,
                         "collectives": rt.n_exchanges - n_ex}
                hb = self._hash_balance(P_new)
                if hb is not None:
                    stats["hash_balance"] = hb
                rt.on_migration(stats)
                self.migrations.append(stats)
        stats["total_s"] = time.perf_counter() - t_total
        stats["host_s"] = stats["total_s"] - t_wave
        return stats

    def _hash_balance(self, P_new: int) -> Optional[dict]:
        """Paper-fidelity report: what consistent hashing (the hash-route
        kernel on a CUDA device) would assign each shard for the SAME live
        positions that round-robin just placed evenly, every window's
        range concatenated.  ``counts`` is the per-shard histogram."""
        ranges = [(lo, hi) for lo, hi in self._live_ranges() if hi >= lo]
        size = sum(hi - lo + 1 for lo, hi in ranges)
        if size <= 0 or size > HASH_BALANCE_MAX_SIZE:
            return None
        pos = torch.cat([torch.arange(lo, hi + 1, dtype=torch.int32,
                                      device=self.device)
                         for lo, hi in ranges])
        _, counts = hash_route(pos, torch.ones(size, dtype=torch.bool,
                                               device=self.device), P_new)
        counts = self.runtime.to_host(counts)
        return {"n": size, "max": int(counts.max()),
                "min": int(counts.min()),
                "roundrobin_max": -(-size // P_new),
                "counts": [int(c) for c in counts]}

    # ------------------------------------------------------- checkpoints ---
    def _layout(self) -> dict:
        return {"kind": self._kind, "n_shards": self.n_shards,
                "cap": self.cap, "W": self.W, "L": self.L}

    @classmethod
    def _layout_kwargs(cls, lay: dict) -> dict:
        return {"cap": lay["cap"], "payload_width": lay["W"],
                "ops_per_shard": lay["L"]}

    def save(self, ckpt_dir, step: int):
        """Checkpoint the state in the reference's format (the layout in
        the manifest's ``meta``).  Returns the committed directory."""
        from ..checkpoint import save_checkpoint
        check_runtime(self.runtime, f"{type(self).__name__}.save", "save")
        with span("checkpoint:save", cat="checkpoint", kind=self._kind,
                  step=step):
            return save_checkpoint(ckpt_dir, step, self._state_dict(),
                                   meta={"layout": self._layout()})

    @classmethod
    def restore(cls, ckpt_dir, step: Optional[int] = None, *,
                n_shards: Optional[int] = None, runtime=None, device=None,
                **kw):
        """Rebuild from a checkpoint written under a possibly different
        shard count (by this package or the reference): a restore at the
        saved count, then one migration to ``n_shards``.

        The shard pool needs ``max(saved, target)`` shards: without a
        ``runtime`` the pool is that size on ``device``; a ``runtime``
        (which keeps its quarantined shards out) must hold as many live
        ones.  ``step`` defaults to the latest committed one.
        """
        from ..checkpoint import latest_step, restore_sharded
        if runtime is not None:
            check_runtime(runtime, f"{cls.__name__}.restore", "save")
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
        manifest = json.loads(
            (Path(ckpt_dir) / f"step_{step}" / "manifest.json").read_text())
        lay = manifest["meta"]["layout"]
        if lay["kind"] != cls._kind:
            raise ValueError(f"checkpoint holds a {lay['kind']}, "
                             f"not a {cls._kind}")
        pool_size = (max(lay["n_shards"], n_shards or 0) if runtime is None
                     else None)
        with span("checkpoint:restore", cat="checkpoint", kind=cls._kind,
                  step=step):
            inst = cls(lay["n_shards"], pool_size=pool_size,
                       runtime=runtime, device=device,
                       **cls._layout_kwargs(lay), **kw)
            placed, _ = restore_sharded(ckpt_dir, step, inst._state_dict(),
                                        inst.device)
            inst.state = inst._from_state_dict(placed)
        if n_shards is not None and n_shards != lay["n_shards"]:
            inst.resize(n_shards)
        return inst

    # ------------------------------------------------- subclass contract ---
    def _make_inner(self, shards: list):
        raise NotImplementedError

    def _migrate(self, a, b, X, Y, old: list, new: list):
        """Move the store from the shard list ``old`` to ``new`` with ONE
        exchange; X/Y hold this process's old shards' rows.  Returns (X,
        Y, moved, lost) for this process's new shards."""
        raise NotImplementedError

    def _old_rows(self, old: list) -> torch.Tensor:
        """``[n_old_local, 1]`` int32: each local store row's index in
        ``old`` (the shard a recovered position lives on)."""
        rt = self.runtime
        idx = (rt.local_rows(old) if rt.multi_process
               else torch.arange(len(old), device=self.device))
        return idx.to(torch.int32)[:, None]

    def _unpack(self, state):
        raise NotImplementedError

    def _pack(self, a, b, X, Y):
        raise NotImplementedError

    def _live_span(self) -> int:
        raise NotImplementedError

    def _live_ranges(self) -> list:
        """The live positions as ``[(lo, hi), ...]`` host ints, one range
        per window."""
        raise NotImplementedError

    def _state_dict(self) -> dict:
        """The state as a dict under the reference's key names."""
        return dict(self.state._asdict())

    def _from_state_dict(self, d: dict):
        return type(self.state)(**d)

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def _entry_bytes(self) -> int:
        raise NotImplementedError


class ElasticDeviceQueue(_ElasticBase):
    """Distributed FIFO whose shard count is a runtime variable.

    Owns its state: ``step``/``run_waves`` mirror :class:`DeviceQueue`
    minus the state argument (the store is updated in place), and
    ``grow``/``shrink``/``resize`` re-materialize the store between
    bursts.

    Args:
      n_shards: initial active shards.
      cap, payload_width, ops_per_shard: as :class:`DeviceQueue`.
      pool_size: shards available for JOIN (default ``n_shards``).
      runtime: a :class:`~repro_torch.runtime.LocalRuntime`,
        :class:`~repro_torch.runtime.SimRuntime` or
        :class:`~repro_torch.runtime.DistributedRuntime` owning the pool
        and device (exclusive with ``pool_size``/``device``).  On a
        multi-process runtime every process passes the same global ops,
        and per-op outputs are its own shards' rows
        (``runtime.to_host(x, eq.shards, lead)`` gathers them).
      device: default CUDA; raises where there is none.
      fused: False runs the five-exchange seed wave (sequential bursts).
      metrics, metrics_ring: a Wavescope row per wave (fused waves only),
        drained into the flight recorder at every burst boundary.
      flight_k: the flight recorder's depth.
    """

    _kind = "queue"

    def __init__(self, n_shards: int, *, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 fused: bool = True, pool_size: Optional[int] = None,
                 runtime=None, device=None, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 flight_k: int = 16):
        self.fused = fused
        super().__init__(n_shards, cap=cap, payload_width=payload_width,
                         ops_per_shard=ops_per_shard, pool_size=pool_size,
                         runtime=runtime, device=device,
                         pipelined=pipelined, metrics=metrics,
                         metrics_ring=metrics_ring, flight_k=flight_k)

    def _make_inner(self, shards: list):
        return DeviceQueue(len(shards), cap=self.cap, payload_width=self.W,
                           ops_per_shard=self.L, fused=self.fused,
                           pipelined=self.pipelined,
                           metrics=self.metrics and self.fused,
                           metrics_ring=self.metrics_ring,
                           runtime=self.runtime, shards=shards)

    # ------------------------------------------------------------ waves ----
    def step(self, is_enq, valid, payload):
        """One wave on the current shards.  Returns (positions, matched,
        deq_vals, deq_ok, overflow) as device tensors; raises
        :class:`~.errors.QueueOverflowError` when the wave overflowed."""
        return self._drive(self.inner.step, False, (is_enq, valid, payload))

    def run_waves(self, is_enq, valid, payload):
        """K pre-staged waves (shapes [K, n_shards * L]).  Raises
        :class:`~.errors.QueueOverflowError` on overflow."""
        return self._drive(self.inner.run_waves, True,
                           (is_enq, valid, payload))

    @property
    def size(self) -> int:
        """Live elements in the FIFO window (``last - first + 1``)."""
        return int(self.state.last) - int(self.state.first) + 1

    # -------------------------------------------------------- migration ----
    def _unpack(self, state):
        return state.first, state.last, state.store_vals, state.store_full

    def _pack(self, a, b, X, Y):
        return DeviceQueueState(a, b, X, Y)

    def _live_ranges(self):
        return [(int(self.state.first), int(self.state.last))]

    def _live_span(self) -> int:
        return max(0, self.size)

    @property
    def _entry_bytes(self) -> int:
        return 4 * (1 + self.W)  # slot ‖ payload columns

    def _migrate(self, first, last, sv, sf, old: list, new: list):
        """The migration body: recover positions, new owner and slot,
        pack, ONE exchange, rewrite.  Returns (store_vals, store_full,
        moved, lost)."""
        cap, W = self.cap, self.W
        P_old, P_new = len(old), len(new)
        dev = sv.device
        M = fanout_bound(P_old, P_new, cap)
        s = self._old_rows(old)
        t = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
        p = recover_positions(s, t, first, P_old, cap)
        live = sf[:, :cap] & (p >= first) & (p <= last)
        owner = torch.remainder(p, P_new).to(torch.int32)
        slot_new = torch.remainder(
            torch.div(p, P_new, rounding_mode="floor"), cap).to(torch.int32)
        cols = torch.cat([slot_new[..., None], sv[:, :cap]], -1)
        del sv
        fill = torch.zeros(1 + W, dtype=torch.int32, device=dev)
        fill[0] = cap
        rows, moved, lost = migrate_packed(self.runtime, old, new, M, live,
                                           owner, cols, fill)
        del cols
        nsv, nsf = rewrite_ring_store(rows, cap, W)
        return nsv, nsf, moved, lost


class ElasticDeviceStack(_ElasticBase):
    """Distributed LIFO whose shard count is a runtime variable.

    Owns its state like :class:`ElasticDeviceQueue`.  Migration flattens
    the (slot, depth) entry set: an entry's position is recovered from its
    slot as for the queue (live window ``[1, last]``), and its depth and
    ticket travel with it.  Valid only while ``last <= P_new * cap``
    (checked before the migration runs).

    Args:
      n_shards, cap, payload_width, ops_per_shard, pool_size, runtime,
      device, pipelined, metrics, metrics_ring, flight_k: as
      :class:`ElasticDeviceQueue`.
      slot_depth: D, the (ticket, payload) entries per store slot.
    """

    _kind = "stack"
    _overflow_detail = ("a store slot's depth-D ticket set was exhausted "
                        "at commit time")

    def __init__(self, n_shards: int, *, cap: int = 1024,
                 payload_width: int = 4, ops_per_shard: int = 64,
                 slot_depth: int = 4, pool_size: Optional[int] = None,
                 runtime=None, device=None, pipelined: bool = True,
                 metrics: bool = False, metrics_ring: int = 64,
                 flight_k: int = 16):
        self.D = slot_depth
        super().__init__(n_shards, cap=cap, payload_width=payload_width,
                         ops_per_shard=ops_per_shard, pool_size=pool_size,
                         runtime=runtime, device=device,
                         pipelined=pipelined, metrics=metrics,
                         metrics_ring=metrics_ring, flight_k=flight_k)

    def _make_inner(self, shards: list):
        return DeviceStack(len(shards), cap=self.cap, payload_width=self.W,
                           ops_per_shard=self.L, slot_depth=self.D,
                           pipelined=self.pipelined, metrics=self.metrics,
                           metrics_ring=self.metrics_ring,
                           runtime=self.runtime, shards=shards)

    # ------------------------------------------------------------ waves ----
    def step(self, is_push, valid, payload):
        """One wave on the current shards.  Returns (positions, matched,
        pop_vals, pop_ok, overflow); raises
        :class:`~.errors.QueueOverflowError` when a slot's ticket set ran
        out."""
        return self._drive(self.inner.step, False,
                           (is_push, valid, payload))

    def run_waves(self, is_push, valid, payload):
        """K pre-staged waves (shapes [K, n_shards * L]).  Raises
        :class:`~.errors.QueueOverflowError` on overflow."""
        return self._drive(self.inner.run_waves, True,
                           (is_push, valid, payload))

    @property
    def size(self) -> int:
        """Live elements on the stack (positions start at 1)."""
        return int(self.state.last)

    def _rematerialize(self, new_active: list, kind: str) -> dict:
        # The migration recovers ONE position per slot, the one in [1,
        # n_shards * cap]; a deeper stack keeps entries of two positions
        # in one slot, and the reference then moves the deeper entry to
        # the shallower one's new slot.  Refuse instead.
        if self.size > self.n_shards * self.cap:
            raise ValueError(
                f"cannot reshard the stack: {self.size} live elements "
                f"exceed the current slots {self.n_shards} * {self.cap}, "
                f"and a slot's positions would be ambiguous")
        return super()._rematerialize(new_active, kind)

    # -------------------------------------------------------- migration ----
    def _unpack(self, state):
        return state.last, state.ticket, state.vals, state.ticks

    def _pack(self, a, b, X, Y):
        return DeviceStackState(a, b, X, Y)

    def _live_ranges(self):
        return [(1, self.size)]

    def _layout(self) -> dict:
        return {**super()._layout(), "D": self.D}

    @classmethod
    def _layout_kwargs(cls, lay: dict) -> dict:
        return {**super()._layout_kwargs(lay), "slot_depth": lay["D"]}

    def _live_span(self) -> int:
        return self.size

    @property
    def _entry_bytes(self) -> int:
        return 4 * (3 + self.W)  # slot ‖ depth ‖ ticket ‖ payload

    def _migrate(self, last, ticket, sv, stk, old: list, new: list):
        """Move every live (slot, depth) entry: ``slot ‖ depth ‖ ticket ‖
        payload`` rows, ONE exchange, then a fresh store.  Returns (vals,
        ticks, moved, lost)."""
        cap, W, D = self.cap, self.W, self.D
        P_old, P_new = len(old), len(new)
        n_mesh = sv.shape[0]              # this process's old shards
        dev = sv.device
        M = min(cap * D, fanout_bound(P_old, P_new, cap) * D)
        s = self._old_rows(old)
        t = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
        p = recover_positions(s, t, 1, P_old, cap)  # positions start at 1
        in_range = (p >= 1) & (p <= last)
        owner = torch.remainder(p, P_new).to(torch.int32)
        slot_new = torch.remainder(
            torch.div(p, P_new, rounding_mode="floor"), cap).to(torch.int32)
        ticks = stk[:, :cap]                                  # [n, cap, D]
        live = ((ticks >= 0) & in_range[..., None]).reshape(n_mesh, -1)
        dep = torch.arange(D, dtype=torch.int32, device=dev).repeat(cap)
        cols = torch.cat(
            [slot_new.repeat_interleave(D, 1)[..., None],
             dep.expand(n_mesh, -1)[..., None],
             ticks.reshape(n_mesh, -1)[..., None],
             sv[:, :cap].reshape(n_mesh, cap * D, W)], -1)
        del sv, stk, ticks
        fill = torch.zeros(3 + W, dtype=torch.int32, device=dev)
        fill[0], fill[2] = cap, -1
        rows, moved, lost = migrate_packed(
            self.runtime, old, new, M, live, owner.repeat_interleave(D, 1),
            cols, fill)
        del cols
        # sentinel rows land on the junk slot, which is then reset
        n_new = rows.shape[0]             # this process's new shards
        shard = torch.arange(n_new, device=dev)[:, None]
        rs, rd = rows[..., 0].long(), rows[..., 1].long()
        nstk = torch.full((n_new, cap + 1, D), -1, dtype=torch.int32,
                          device=dev)
        nstk[shard, rs, rd] = rows[..., 2]
        nstk[:, cap] = -1
        nsv = torch.zeros((n_new, cap + 1, D, W), dtype=torch.int32,
                          device=dev)
        nsv[shard, rs, rd] = rows[..., 3:]
        nsv[:, cap] = 0
        return nsv, nstk, moved, lost


class _MultiWindowElastic(_ElasticBase):
    """Shared elastic machinery for structures whose ring store is split
    into ``_n_windows`` round-robin slot windows, one ``[first, last]``
    interval each (priority tiers).  The state exposes ``firsts``/
    ``lasts`` ``[n_windows]`` vectors; one migration recovers every
    window's positions and moves all windows with ONE packed exchange."""

    @property
    def _n_windows(self) -> int:
        raise NotImplementedError

    @property
    def sizes(self) -> list:
        """Per-window occupancy (one host int per window)."""
        f = self.runtime.to_host(self.state.firsts)
        last = self.runtime.to_host(self.state.lasts)
        return [int(x) for x in (last - f + 1)]

    @property
    def size(self) -> int:
        """Total live elements across every window."""
        return sum(self.sizes)

    def _occupancies(self) -> list:
        return self.sizes

    def _live_span(self) -> int:
        # the capacity check is per window (each owns its slot range)
        return max([0] + self.sizes)

    def _live_ranges(self):
        f = self.runtime.to_host(self.state.firsts)
        last = self.runtime.to_host(self.state.lasts)
        return [(int(a), int(b)) for a, b in zip(f, last)]

    @property
    def _entry_bytes(self) -> int:
        return 4 * (1 + self.W)  # slot ‖ payload columns

    def _migrate(self, firsts, lasts, sv, sf, old: list, new: list):
        """Recover every window's window-local positions, route them,
        ONE exchange (``M = min(W * cap, W * fanout_bound)`` rows per
        destination, ``W`` windows), rewrite.  Returns (store_vals,
        store_full, moved, lost)."""
        cap, W = self.cap, self.W
        n_win = self._n_windows
        P_old, P_new = len(old), len(new)
        dev = sv.device
        M = min(n_win * cap, n_win * fanout_bound(P_old, P_new, cap))
        junk = n_win * cap
        s = self._old_rows(old)
        u = torch.arange(junk, dtype=torch.int32, device=dev)[None, :]
        win = torch.div(u, cap, rounding_mode="floor").long()
        f_w, l_w = firsts[win], lasts[win]                    # [1, junk]
        p = recover_positions(s, torch.remainder(u, cap), f_w, P_old, cap)
        live = sf[:, :junk] & (p >= f_w) & (p <= l_w)
        owner = torch.remainder(p, P_new).to(torch.int32)
        slot_new = (win * cap + torch.remainder(
            torch.div(p, P_new, rounding_mode="floor"), cap)).to(torch.int32)
        cols = torch.cat([slot_new[..., None], sv[:, :junk]], -1)
        del sv
        fill = torch.zeros(1 + W, dtype=torch.int32, device=dev)
        fill[0] = junk
        rows, moved, lost = migrate_packed(self.runtime, old, new, M, live,
                                           owner, cols, fill)
        del cols
        nsv, nsf = rewrite_ring_store(rows, junk, W)
        return nsv, nsf, moved, lost
