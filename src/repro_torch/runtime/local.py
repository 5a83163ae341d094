"""LocalRuntime: every shard a row of tensors on one device.

Counterpart of ``repro/runtime/local.py``.  The pool is ``pool_size``
virtual shards with stable ids 0..pool_size-1, all held by this process.
The exchange is a transpose of the ``[src, dst, ...]`` send buffer and the
gather the identity, both counted, so a run can show the reference's
collective budget: 2 exchanges per ``step``, K+1 per pipelined K-wave
burst, 2K per sequential burst, 1 per migration.
"""
from __future__ import annotations

import torch

from .base import Runtime, VirtualShard


class LocalRuntime(Runtime):
    """Single-device runtime over ``pool_size`` virtual shards."""

    kind = "local"

    def __init__(self, pool_size: int, device=None):
        super().__init__(device)
        if pool_size < 1:
            raise ValueError("LocalRuntime needs at least one shard")
        self._devices = [VirtualShard(i) for i in range(int(pool_size))]

    def all_devices(self) -> list:
        return list(self._devices)

    def exchange(self, buf: torch.Tensor, src=None, dst=None) -> torch.Tensor:
        """``buf[src, dst, ...]`` -> ``out[dst, src, ...]``: shard ``d``
        receives row ``d`` of every sender, in sender order, as the
        reference's tiled ``all_to_all`` delivers it."""
        self._count_exchange(buf)
        return buf.transpose(0, 1).contiguous()

    def gather(self, x: torch.Tensor, shards=None) -> torch.Tensor:
        """Every shard is local: the rows as they are, counted."""
        self.n_gathers += 1
        return x
