"""Work-stealing queue with lease-based straggler mitigation.

Counterpart of ``repro/dqueue/work_queue.py``: the paper's motivating
application (Sec. I), FIFO work stealing.  Work items enter the
distributed queue; workers dequeue in sequentially-consistent FIFO order.
For fault tolerance at fleet scale:

* every dequeue is a *lease*: the item is re-enqueued if not acknowledged
  within ``lease_steps`` (dead or straggling workers);
* duplicate completions are idempotent (first ack wins), which makes
  speculative backup execution of leased-but-slow items safe.

Runs on the host around a :class:`~.device_queue.DeviceQueue`, so the
item payloads live sharded on the device and the global FIFO order is the
queue's order.  :meth:`WorkQueue.run_waves` stages K scheduling steps as
``[K, n]`` op batches and runs them as ONE ``DeviceQueue.run_waves``
burst.  Leases held at burst start have predictable expiry times, so
their retries are staged into exactly the wave where a per-step loop
would re-enqueue them; leases granted inside the burst are seen at the
next burst boundary.  A lease granted at wave j expires only after
``lease_steps`` more steps, so bursts of at most ``lease_steps + 1``
waves are exactly the per-step schedule; longer horizons are cut into
sub-bursts of that length.  :meth:`WorkQueue.step` is the K=1 case.

The grants, the lease dict (its order too) and the stats are the
reference's.  The staging is numpy over whole waves, and the expiry scan
stops at the first unexpired lease while the dict's issue steps are in
order (which a re-grant of a held id breaks; then it scans them all).
The queue must be on one process, as in the reference: the grants are
read from whole host arrays, and the reference's own ``WorkQueue`` reads
the sharded dequeue outputs with ``np.asarray``
(``repro/dqueue/work_queue.py:178-179``), which its multi-process
runtime refuses.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import repeat
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..obs.recorder import FlightRecorder
from ..obs.trace import span
from .device_queue import DeviceQueue, check_runtime
from .errors import QueueOverflowError


@dataclass
class _Lease:
    item: np.ndarray
    issued_step: int
    worker: int


class WorkQueue:
    """Lease-based work-stealing scheduler over a :class:`DeviceQueue`.

    Args:
      dq: the backing device queue (item payloads live sharded on it), on
        a LocalRuntime or SimRuntime.
      lease_steps: steps before an unacknowledged dequeue is reissued.
      flight_k: flight-recorder depth for the telemetry trajectory.

    Raises:
      QueueOverflowError: on oversized submit batches ("work") or when
        the backing device queue overflows ("workqueue").
      NotImplementedError: on a multi-process runtime (as the
        reference, which runs it on one process only).
    """

    def __init__(self, dq: DeviceQueue, lease_steps: int = 8,
                 flight_k: int = 16):
        check_runtime(dq.runtime, "WorkQueue", "WorkQueue")
        self.dq = dq
        self.state = dq.init_state()
        self.lease_steps = lease_steps
        self.step_no = 0
        self.leases: Dict[int, _Lease] = {}   # element-id -> lease
        self.completed: set = set()
        self.stats = {"reissued": 0, "duplicate_acks": 0, "items_done": 0}
        self._next_eid = 0
        self._in_order = True   # leases' issue steps ascend in dict order
        self.recorder = FlightRecorder(flight_k)

    def _drain_telemetry(self) -> None:
        """Burst-boundary Wavescope drain (nothing unless the backing
        DeviceQueue was built with ``metrics=True``)."""
        eng = getattr(self.dq, "engine", None)
        if eng is not None and eng.metrics:
            self.recorder.extend(eng.drain_metrics(reset=True))

    def trajectory(self) -> list:
        """Flight-recorder trajectory (last K wave summaries)."""
        return self.recorder.trajectory()

    # -- one synchronous scheduling step ------------------------------------
    def step(self, submit, want: List[int]) -> List[Tuple[int, np.ndarray]]:
        """Submit new items and serve ``want[w]`` dequeues for worker w.
        Returns (worker, payload) grants.  Expired leases are re-enqueued
        ahead of new submissions (FIFO fairness for retries)."""
        return self.run_waves([submit], [want])[0]

    def _expired(self, step_k: int) -> list:
        """Leases expiring by ``step_k`` and not completed, in dict order."""
        out = []
        for eid, lease in self.leases.items():
            if step_k - lease.issued_step > self.lease_steps:
                if eid not in self.completed:
                    out.append(lease)
            elif self._in_order:
                break           # every later lease was issued no earlier
        return out

    # -- a burst of K scheduling steps in one device dispatch ---------------
    def run_waves(self, submits, wants: List[List[int]]
                  ) -> List[List[Tuple[int, np.ndarray]]]:
        """Run ``K = len(submits)`` scheduling steps as one multi-wave
        queue burst.  ``submits[k]`` are the items entering at wave k (a
        list of int32 arrays, or one ``[m, <=W]`` array) and
        ``wants[k][w]`` the dequeue count of worker w at wave k.  Returns
        the per-wave grant lists.  A pre-burst lease expiring at wave k is
        re-enqueued ahead of wave k's submissions, as the per-step loop
        would; bursts longer than ``lease_steps + 1`` waves are cut into
        sub-bursts of that length."""
        K = len(submits)
        if K != len(wants) or K < 1:
            raise ValueError(
                f"run_waves needs aligned non-empty burst lists: "
                f"{K} submit waves vs {len(wants)} want waves")
        H = self.lease_steps + 1
        if K > H:
            out: List[List[Tuple[int, np.ndarray]]] = []
            for i in range(0, K, H):
                out.extend(self.run_waves(submits[i:i + H], wants[i:i + H]))
            return out
        first_step = self.step_no + 1

        n = self.dq.n_shards * self.dq.L
        W = self.dq.W
        is_enq = np.zeros((K, n), bool)
        valid = np.zeros((K, n), bool)
        payload = np.zeros((K, n, W), np.int32)
        wave_meta: List[Tuple[int, np.ndarray]] = []
        for k in range(K):
            # pre-burst leases expiring at step first_step + k retry HERE
            expired = self._expired(first_step + k)
            for lease in expired:
                self.stats["reissued"] += 1
                self.leases.pop(int(lease.item[0]), None)
            sub = submits[k]
            n_sub = len(sub)
            n_enq = len(expired) + n_sub
            want = np.asarray(wants[k], np.int64)
            n_deq = int(want.sum())
            if n_enq + n_deq > n:
                raise QueueOverflowError(
                    "work", n, [n_enq + n_deq], wave=k,
                    detail="batch larger than queue wave: shrink the "
                           "wave's submits/wants or raise ops_per_shard")
            for i, lease in enumerate(expired):
                payload[k, i, :len(lease.item)] = lease.item
            if isinstance(sub, np.ndarray) and sub.ndim == 2:
                payload[k, len(expired):n_enq, :sub.shape[1]] = sub
            else:
                for i, item in enumerate(sub, len(expired)):
                    payload[k, i, :len(item)] = item
            is_enq[k, :n_enq] = True
            valid[k, :n_enq + n_deq] = True
            wave_meta.append((n_enq, want))

        self.step_no += K
        dev = self.dq.device
        with span("workqueue:burst", cat="wave", K=K,
                  leases=len(self.leases)):
            self.state, pos, matched, deq_vals, deq_ok, overflow = \
                self.dq.run_waves(self.state, torch.from_numpy(is_enq).to(dev),
                                  torch.from_numpy(valid).to(dev),
                                  torch.from_numpy(payload).to(dev))
        self._drain_telemetry()
        rt = self.dq.runtime
        o = rt.to_host(overflow)
        if bool(o.any()):
            size = (int(rt.to_host(self.state.last))
                    - int(rt.to_host(self.state.first)) + 1)
            raise QueueOverflowError(
                "workqueue", self.dq.n_shards * self.dq.cap, [size],
                wave=int(np.flatnonzero(o)[0]) if o.ndim >= 1 else None,
                detail=f"{len(self.leases)} leases outstanding, "
                       f"{self.stats['items_done']} items done",
                trajectory=self.recorder.trajectory())
        deq_vals = rt.to_host(deq_vals)
        deq_ok = rt.to_host(deq_ok)
        all_grants: List[List[Tuple[int, np.ndarray]]] = []
        for k, (n_enq, want) in enumerate(wave_meta):
            workers = np.repeat(np.arange(want.size), want)
            hit = n_enq + np.flatnonzero(deq_ok[k, n_enq:n_enq + workers.size])
            items = list(deq_vals[k, hit])
            ws = workers[hit - n_enq].tolist()
            eids = deq_vals[k, hit, 0].tolist()
            if not self.leases.keys().isdisjoint(eids):
                self._in_order = False     # a re-grant keeps its place
            # in grant order, as one assignment per grant would
            self.leases.update(zip(eids, map(_Lease, items,
                                             repeat(first_step + k), ws)))
            all_grants.append(list(zip(ws, items)))
        return all_grants

    def make_item(self, data: List[int]) -> np.ndarray:
        """Items carry a unique id in word 0 (dedup across re-issues)."""
        eid = self._next_eid
        self._next_eid += 1
        item = np.zeros(self.dq.W, np.int32)
        item[0] = eid
        item[1: 1 + len(data)] = data
        return item

    def ack(self, item: np.ndarray) -> bool:
        """Worker completion.  Returns True if this ack won (first)."""
        eid = int(item[0])
        if eid in self.completed:
            self.stats["duplicate_acks"] += 1
            return False
        self.completed.add(eid)
        self.leases.pop(eid, None)
        self.stats["items_done"] += 1
        return True

    @property
    def outstanding(self) -> int:
        """Leased-but-unacknowledged item count."""
        return len(self.leases)
