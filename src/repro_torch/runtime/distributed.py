"""DistributedRuntime: shards split over processes by ``torch.distributed``.

Counterpart of ``repro/runtime/distributed.py``.  N processes form one
runtime: the pool is ``N * shards_per_process`` virtual shards, and shard
``id`` belongs to process ``id // shards_per_process`` for the run's
life.  A process holds the store rows of its own shards; the wave's
all-to-alls are real messages between processes, LEAVE and JOIN are
cross-process reshards, and the paper's model of computation (processes
exchanging messages) runs as written.

The data plane, over a structure's active order (``base`` module):

* :meth:`exchange`: ``buf[src_local, dst, ...]`` ->
  ``out[dst_local, src, ...]`` is ONE ``all_to_all_single``, its split
  sizes taken from how the active order falls on the processes;
* :meth:`gather`: ``x[local, ...]`` -> ``[n, ...]`` in active order is
  ONE ``all_gather_into_tensor``, padded to the largest local count (a
  LEAVE leaves the processes uneven) and reordered by the active order;
* :meth:`place` keeps the local shards' rows of a global host array
  (every process passes the same values, as in the reference);
  :meth:`to_host` gathers sharded values into the global order and reads
  replicated ones locally; :meth:`sync` is a barrier.

After a LEAVE and a JOIN the active order interleaves the processes'
shards (a regrown shard is appended at the end, as in the reference), so
every split, gather and reorder follows the active order, never the
process order.  Every process must hold at least one shard of every
shard set it runs over.

The backend is gloo, the reference's only one (``distributed.py:73``).
It takes CUDA tensors directly (it stages them through host memory
itself), so the kernels run on the card in every process and the wire is
gloo's.  NCCL refuses two ranks on one card.

Launch: every process calls ::

    rt = DistributedRuntime.initialize("127.0.0.1:29511", num_processes=2,
                                       process_id=pid, shards_per_process=32)

or exports ``REPRO_RT_COORD`` / ``REPRO_RT_NPROCS`` / ``REPRO_RT_PID`` /
``REPRO_RT_SHARDS`` and calls :meth:`DistributedRuntime.from_env`
(``launcher.launch_localhost`` sets them).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .base import ProcessRole, Runtime, VirtualShard

ENV_COORD = "REPRO_RT_COORD"
ENV_NPROCS = "REPRO_RT_NPROCS"
ENV_PID = "REPRO_RT_PID"
ENV_SHARDS = "REPRO_RT_SHARDS"


class _Layout(NamedTuple):
    """How one shard list falls on the processes."""
    by_proc: tuple          # per process: its shards' active indices
    by_proc_t: tuple        # the same as int64 tensors on the device
    local: torch.Tensor     # this process's active indices (device)
    local_cpu: torch.Tensor  # the same on the host (placing host arrays)
    grouped_row: torch.Tensor  # active index -> its row in process order
    gather_take: torch.Tensor  # active index -> row of the padded gather
    pad: int                # the largest local count


class DistributedRuntime(Runtime):
    """Runtime over an initialised ``torch.distributed`` world of at least
    two processes, ``shards_per_process`` shards each, on ``device``."""

    kind = "distributed"

    def __init__(self, shards_per_process: int, device=None):
        super().__init__(device)
        if not dist.is_initialized() or dist.get_world_size() < 2:
            raise RuntimeError(
                "DistributedRuntime needs an initialised torch.distributed "
                "world of two or more processes: call "
                "DistributedRuntime.initialize(...) first, or use "
                "LocalRuntime for one process")
        if shards_per_process < 1:
            raise ValueError("shards_per_process must be at least 1")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.shards_per_process = int(shards_per_process)
        self._devices = [VirtualShard(i)
                         for i in range(self.world * self.shards_per_process)]
        self._layouts: dict = {}

    # ---------------------------------------------------------- launch -----
    @classmethod
    def initialize(cls, coordinator: str, num_processes: int,
                   process_id: int, *, shards_per_process: int,
                   device=None, backend: str = "gloo"
                   ) -> "DistributedRuntime":
        """Join the world and build the runtime: blocks until all
        ``num_processes`` processes have connected to ``coordinator``
        (``host:port``; process 0 hosts it)."""
        if backend != "gloo":
            raise ValueError(f"backend {backend!r}: only gloo is supported "
                             "(NCCL refuses two ranks on one card)")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id))
        return cls(shards_per_process, device=device)

    @classmethod
    def from_env(cls, device=None) -> "DistributedRuntime":
        """:meth:`initialize` from the launcher's variables
        (``REPRO_RT_COORD`` / ``REPRO_RT_NPROCS`` / ``REPRO_RT_PID`` /
        ``REPRO_RT_SHARDS``)."""
        try:
            coord = os.environ[ENV_COORD]
            nprocs = int(os.environ[ENV_NPROCS])
            pid = int(os.environ[ENV_PID])
            spp = int(os.environ[ENV_SHARDS])
        except KeyError as e:
            raise RuntimeError(
                f"DistributedRuntime.from_env: {e.args[0]} is not set; "
                "launch through repro_torch.runtime.launch_localhost or "
                f"export {ENV_COORD}/{ENV_NPROCS}/{ENV_PID}/{ENV_SHARDS}"
            ) from None
        return cls.initialize(coord, nprocs, pid, shards_per_process=spp,
                              device=device)

    def close(self) -> None:
        """Leave the world (a barrier first, so no process exits while
        another still sends)."""
        self.sync()
        dist.destroy_process_group()

    # -------------------------------------------------------- topology -----
    def all_devices(self) -> list:
        return list(self._devices)

    @property
    def process_role(self) -> ProcessRole:
        return ProcessRole(self.rank, self.world, self.rank == 0)

    def owner_process(self, shard_id: int) -> int:
        """The process that holds shard ``shard_id``."""
        return int(shard_id) // self.shards_per_process

    def local_devices(self) -> list:
        """The pool's shards this process holds."""
        return [d for d in self.pool()
                if self.owner_process(d.id) == self.rank]

    def local_shards(self, shards: Sequence) -> list:
        return [s for s in shards if self.owner_process(s.id) == self.rank]

    def _layout(self, shards: Sequence) -> _Layout:
        key = tuple(int(s.id) for s in shards)
        lay = self._layouts.get(key)
        if lay is not None:
            return lay
        by_proc = tuple(tuple(a for a, i in enumerate(key)
                              if self.owner_process(i) == q)
                        for q in range(self.world))
        empty = [q for q, b in enumerate(by_proc) if not b]
        if empty:
            raise ValueError(f"process(es) {empty} hold no shard of "
                             f"{list(key)}: every process must hold at "
                             f"least one")
        pad = max(len(b) for b in by_proc)
        grouped = [a for b in by_proc for a in b]
        row = np.empty(len(key), np.int64)
        row[grouped] = np.arange(len(key))
        take = np.empty(len(key), np.int64)
        for q, b in enumerate(by_proc):
            take[list(b)] = q * pad + np.arange(len(b))
        dev = self.device
        by_proc_t = tuple(torch.tensor(b, dtype=torch.int64, device=dev)
                          for b in by_proc)
        lay = _Layout(by_proc, by_proc_t, by_proc_t[self.rank],
                      torch.tensor(by_proc[self.rank], dtype=torch.int64),
                      torch.from_numpy(row).to(dev),
                      torch.from_numpy(take).to(dev), pad)
        self._layouts[key] = lay
        return lay

    def local_rows(self, shards: Sequence) -> torch.Tensor:
        """Active indices of this process's shards of ``shards`` (int64,
        on the device)."""
        return self._layout(shards).local

    # ------------------------------------------------------ data plane -----
    def exchange(self, buf: torch.Tensor, src: Optional[Sequence] = None,
                 dst: Optional[Sequence] = None) -> torch.Tensor:
        """ONE ``all_to_all_single``: this process sends each destination
        process its shards' columns of ``buf`` and receives every sender's
        rows for its own shards, then puts the senders in active order."""
        if src is None:
            raise ValueError("a multi-process exchange needs its shard list")
        dst = src if dst is None else dst
        self.n_exchanges += 1
        ls, ld = self._layout(src), self._layout(dst)
        is_bool = buf.dtype == torch.bool
        if is_bool:                   # gloo moves bytes, not bools
            buf = buf.view(torch.uint8)
        rest = buf.shape[2:]
        n_me = buf.shape[0]
        me_dst = len(ld.by_proc[self.rank])
        row = int(np.prod(rest, dtype=np.int64))
        send = torch.cat([buf.index_select(1, b).reshape(-1)
                          for b in ld.by_proc_t])
        in_splits = [n_me * len(b) * row for b in ld.by_proc]
        out_splits = [len(b) * me_dst * row for b in ls.by_proc]
        recv = torch.empty(sum(out_splits), dtype=buf.dtype,
                           device=buf.device)
        dist.all_to_all_single(recv, send, out_splits, in_splits)
        # recv: the senders' [n_src_q, me_dst, ...] blocks in process order
        recv = recv.view(len(src), me_dst, *rest).transpose(0, 1)
        out = recv.index_select(1, ls.grouped_row)
        return out.view(torch.bool) if is_bool else out

    def gather(self, x: torch.Tensor, shards: Sequence) -> torch.Tensor:
        """ONE ``all_gather_into_tensor`` of ``x[local, ...]``, padded to
        the largest local count; returns ``[len(shards), ...]`` in active
        order."""
        self.n_gathers += 1
        lay = self._layout(shards)
        is_bool = x.dtype == torch.bool
        if is_bool:
            x = x.view(torch.uint8)
        if x.shape[0] < lay.pad:
            x = torch.cat([x, x.new_zeros((lay.pad - x.shape[0],)
                                          + x.shape[1:])])
        out = torch.empty((self.world * lay.pad,) + x.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        out = out.index_select(0, lay.gather_take)
        return out.view(torch.bool) if is_bool else out

    def to_host(self, x, shards: Optional[Sequence] = None,
                lead: int = 0) -> np.ndarray:
        if shards is None or not torch.is_tensor(x):
            return super().to_host(x)
        n_local = len(self._layout(shards).by_proc[self.rank])
        xs = x.movedim(lead, 0)
        rows = xs.reshape(n_local, -1, *xs.shape[1:]).contiguous()
        g = self.gather(rows, shards)
        return super().to_host(g.reshape(-1, *g.shape[2:]).movedim(0, lead))

    def host_reduce(self, x: torch.Tensor, op: str = "sum") -> np.ndarray:
        """ONE ``all_gather_into_tensor`` of the per-process value, then
        the sum or the or over the processes on the host."""
        self.n_gathers += 1
        v = x.to(torch.int64).reshape(1, -1)
        out = torch.empty((self.world, v.shape[1]), dtype=torch.int64,
                          device=v.device)
        dist.all_gather_into_tensor(out, v.contiguous())
        h = out.cpu().numpy().reshape((self.world,) + tuple(x.shape))
        return h.any(0) if op == "any" else h.sum(0)

    def place(self, x, shards: Optional[Sequence] = None,
              lead: int = 0) -> torch.Tensor:
        if shards is None:
            raise ValueError("a multi-process place needs its shard list")
        lay = self._layout(shards)
        t = torch.as_tensor(x)
        sh = t.shape
        t = t.reshape(*sh[:lead], len(shards), -1, *sh[lead + 1:])
        t = t.index_select(lead, lay.local if t.is_cuda else lay.local_cpu)
        return t.reshape(*sh[:lead], -1, *sh[lead + 1:]).to(self.device)

    def sync(self) -> None:
        super().sync()
        dist.barrier()
