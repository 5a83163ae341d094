"""The Runtime contract: who owns the shards, the device and the wire.

Counterpart of ``repro/runtime/base.py``.  Everything above the runtime
(the wave engine, the FIFO discipline, the elastic wrapper) speaks in
stable shard ids and calls the runtime's one exchange seam for every
collective of the reference.  An implementation decides what a shard
physically is; :class:`~repro_torch.runtime.local.LocalRuntime` makes it
one row of the leading dimension of tensors on one device.

Stable identity and quarantine follow the reference: a shard's ``.id``
never changes, ``mark_failed`` removes it from :meth:`Runtime.pool` for
good, and JOIN draws capacity from ``pool()`` only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.backend import resolve_device


class VirtualShard(NamedTuple):
    """One shard of the pool; ``id`` is its stable identity."""
    id: int


class Runtime:
    """Base contract: the shard pool, failure quarantine, the host/device
    data plane and the exchange seam.  ``n_exchanges`` counts every call
    of :meth:`exchange` (the reference's ``all_to_all`` count)."""

    kind: str = "base"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._failed: set = set()
        self.n_exchanges = 0

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

    # ------------------------------------------------------- liveness ------
    def mark_failed(self, device_id: int) -> None:
        """Quarantine a shard by stable id: it leaves :meth:`pool` for
        good, so JOIN can never resurrect state onto it."""
        self._failed.add(int(device_id))

    # ----------------------------------------------------- data plane ------
    def exchange(self, buf: torch.Tensor) -> torch.Tensor:
        """The all-to-all: ``buf[src, dst, ...]`` -> ``out[dst, src, ...]``."""
        raise NotImplementedError

    def to_host(self, x) -> np.ndarray:
        """Copy a tensor to host memory (a sync point)."""
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    def place(self, x) -> torch.Tensor:
        """Stage one host or device array onto this runtime's device."""
        return torch.as_tensor(x, device=self.device)

    def sync(self) -> None:
        """Wait for the device's queued work (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------ injection hooks ------
    def on_burst(self, kind: str, n_waves: int, n_shards: int, *,
                 width: int, payload_width: int,
                 pipelined: bool = True) -> None:
        """Burst-boundary notification from the elastic wrapper (no-op)."""

    def on_migration(self, stats: dict) -> None:
        """Migration-wave notification (no-op)."""

