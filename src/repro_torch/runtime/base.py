"""The Runtime contract: who owns the shards, the device and the wire.

Counterpart of ``repro/runtime/base.py``.  Everything above the runtime
(the wave engine, the disciplines, the elastic wrappers, the fault layer)
speaks in stable shard ids and calls the runtime's two counted seams for
every collective of the reference:

* :meth:`Runtime.exchange`, the all-to-all (``n_exchanges``; the
  reference's ``all_to_all`` budget: 2 per ``step``, K+1 per pipelined
  K-wave burst, 1 per migration; ``exchange_bytes``, the bytes of the
  send buffers);
* :meth:`Runtime.gather`, the all-gather of each local shard's rows over
  the processes (``n_gathers``): the wave's op descriptors on a
  multi-process runtime, and the host reads of sharded values.

The implementations decide what a shard physically is:

* :class:`~repro_torch.runtime.local.LocalRuntime`: every shard one row
  of the leading dimension of tensors on one device; the exchange is a
  transpose and the gather the identity;
* :class:`~repro_torch.runtime.sim.SimRuntime`: LocalRuntime plus a
  modelled wire (launches and bytes priced by a latency model) and
  scheduled shard failures;
* :class:`~repro_torch.runtime.distributed.DistributedRuntime`: shards
  split over processes joined by ``torch.distributed``; a process holds
  the rows of its own shards and the exchange is one
  ``all_to_all_single``.

Shard sets and the active order
-------------------------------
A structure runs over an ordered list of shards, its *active order*
(the reference's mesh): position ``p`` lives on the shard at index
``p % n`` of that list.  The data-plane methods take that list; a
tensor with a leading shard dimension holds this process's shards of it
(:meth:`Runtime.local_shards`), in active order.  On one process that is
the whole list.

Stable identity and quarantine follow the reference: a shard's ``.id``
never changes, ``mark_failed`` removes it from :meth:`Runtime.pool` for
good, and JOIN draws capacity from ``pool()`` only.

The reference's ``build_mesh`` and ``as_runtime`` build and adopt XLA
meshes; a shard list takes the mesh's place here, so neither exists.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.backend import resolve_device


class VirtualShard(NamedTuple):
    """One shard of the pool; ``id`` is its stable identity."""
    id: int


class ProcessRole(NamedTuple):
    """This process's place in the runtime: ``index`` of ``count``
    processes; ``coordinator`` is True exactly for process 0 (the one that
    should write artifacts and drive single-writer side effects)."""
    index: int
    count: int
    coordinator: bool


def select_devices(devs: Sequence, n_shards: int, exclude=()) -> list:
    """Drop ``exclude`` (shards or bare ids), then take the first
    ``n_shards`` of what survives.

    Raises with the excluded id named when the exclusion makes
    ``n_shards`` unsatisfiable, instead of a bare count mismatch."""
    devs = list(devs)
    excl_ids = {d if isinstance(d, int) else d.id for d in exclude}
    live = [d for d in devs if d.id not in excl_ids]
    if not 1 <= n_shards <= len(live):
        hit = sorted(i for i in excl_ids if any(d.id == i for d in devs))
        if hit:
            raise ValueError(
                f"cannot build a {n_shards}-shard mesh: excluding "
                f"device id(s) {hit} leaves only {len(live)} of "
                f"{len(devs)} devices")
        raise ValueError(
            f"cannot build a {n_shards}-shard mesh from {len(live)} "
            f"devices")
    return live[:n_shards]


class Runtime:
    """Base contract: the shard pool, failure quarantine, the host/device
    data plane and the two counted seams.  ``n_exchanges`` counts every
    :meth:`exchange` (the reference's ``all_to_all`` count) and
    ``exchange_bytes`` the bytes of the send buffers passed to it
    (``numel × element_size``, no device read); ``n_gathers`` counts
    every :meth:`gather`."""

    kind: str = "base"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._failed: set = set()
        self.n_exchanges = 0
        self.exchange_bytes = 0
        self.n_gathers = 0

    # ------------------------------------------------------- topology ------
    def all_devices(self) -> list:
        """Every shard this runtime was built over, failed included, in
        stable order."""
        raise NotImplementedError

    def pool(self) -> list:
        """Live (non-quarantined) shards, in stable order."""
        return [d for d in self.all_devices() if d.id not in self._failed]

    @property
    def pool_size(self) -> int:
        """Number of live shards (the hard upper bound on active shards)."""
        return len(self.pool())

    @property
    def process_role(self) -> ProcessRole:
        """This process's (index, count, coordinator) role."""
        return ProcessRole(0, 1, True)

    @property
    def multi_process(self) -> bool:
        """True when shards are split over more than one process."""
        return self.process_role.count > 1

    def local_shards(self, shards: Sequence) -> list:
        """The shards of ``shards`` this process holds, in their order
        there (on one process: all of them)."""
        return list(shards)

    # ------------------------------------------------------- liveness ------
    def mark_failed(self, device_id: int) -> None:
        """Quarantine a shard by stable id: it leaves :meth:`pool` for
        good, so JOIN can never resurrect state onto it."""
        self._failed.add(int(device_id))

    @property
    def failed_ids(self) -> frozenset:
        """Stable ids of every quarantined shard."""
        return frozenset(self._failed)

    # ----------------------------------------------------- data plane ------
    def _count_exchange(self, buf: torch.Tensor) -> None:
        """Count one exchange of the send buffer ``buf``."""
        self.n_exchanges += 1
        self.exchange_bytes += buf.numel() * buf.element_size()

    def exchange(self, buf: torch.Tensor, src: Optional[Sequence] = None,
                 dst: Optional[Sequence] = None) -> torch.Tensor:
        """The all-to-all: ``buf[src_local, dst, ...]`` ->
        ``out[dst_local, src, ...]`` over the shard lists ``src`` and
        ``dst`` (``dst`` defaults to ``src``; the migration moves from
        the old set to the new one)."""
        raise NotImplementedError

    def gather(self, x: torch.Tensor, shards: Sequence) -> torch.Tensor:
        """The all-gather: ``x[local, ...]`` (this process's shards of
        ``shards``) -> ``[len(shards), ...]`` in active order."""
        raise NotImplementedError

    def to_host(self, x, shards: Optional[Sequence] = None,
                lead: int = 0) -> np.ndarray:
        """Copy a tensor to host memory (a sync point).  Without
        ``shards`` the value is replicated and read locally; with them,
        axis ``lead`` holds this process's shards' rows (``[n_local·L]``)
        and the result the whole list's (``[n·L]``, active order)."""
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    def host_reduce(self, x: torch.Tensor, op: str = "sum") -> np.ndarray:
        """A per-process value summed (``op="sum"``) or or-ed
        (``op="any"``) over the processes, on the host: the reference's
        ``psum`` / ``pmax`` of a per-shard value, taken where the caller
        reads it.  On one process a host read."""
        h = self.to_host(x)
        return h.astype(bool) if op == "any" else h

    def place(self, x, shards: Optional[Sequence] = None,
              lead: int = 0) -> torch.Tensor:
        """Stage one wave-op array on this runtime's device: this
        process's shards' rows of axis ``lead`` of the global array (every
        process passes the same host values, as in the reference).  On
        one process the whole array."""
        return torch.as_tensor(x, device=self.device)

    def sync(self) -> None:
        """Wait for the device's queued work (no-op on the CPU); a barrier
        across the processes of a multi-process runtime."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------ injection hooks ------
    def collective_latency(self, kind: str, nbytes: int = 0) -> float:
        """Modelled seconds one ``kind`` collective of ``nbytes`` costs
        (0 everywhere except :class:`~.sim.SimRuntime`)."""
        return 0.0

    def on_burst(self, kind: str, n_waves: int, n_shards: int, *,
                 width: int, payload_width: int,
                 pipelined: bool = True) -> None:
        """Burst-boundary notification from the elastic wrapper (no-op
        except under SimRuntime, which charges the modelled launches)."""

    def on_migration(self, stats: dict) -> None:
        """Migration-wave notification (SimRuntime charges the wire model
        and annotates ``stats`` in place)."""

    def maybe_fail(self, step: int) -> None:
        """Scheduled-failure hook (SimRuntime raises ``ShardFailure``
        here); the fault layer calls it once per step."""

    def snapshot(self) -> dict:
        """Metrics-ready description of this runtime."""
        role = self.process_role
        return {"kind": self.kind, "device": str(self.device),
                "pool_size": self.pool_size,
                "failed_ids": sorted(self._failed),
                "process_index": role.index,
                "process_count": role.count,
                "n_exchanges": self.n_exchanges,
                "exchange_bytes": self.exchange_bytes,
                "n_gathers": self.n_gathers}
