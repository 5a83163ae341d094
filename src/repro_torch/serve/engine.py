"""Continuous-batching serving engine fed by the Skueue request queue.

Counterpart of ``repro/serve/engine.py`` in its FIFO mode.  Requests are
enqueued into an :class:`~repro_torch.dqueue.ElasticDeviceQueue`
(payload = request id) and admitted to decode slots in the queue's
sequentially consistent FIFO order.  ``submit`` stages arrivals host-side;
each engine step flushes the staged enqueues and the free slots' dequeues
as ONE chunked burst of fused queue waves (``run_waves``), at the
narrowest width of the queue's bucket ladder that holds them, the wave
count padded to a power of two.  The engine mirrors the queue size on the
host, so draining never reads device state between steps.  ``resize``
drains staged submissions into the queue and re-materializes it onto a
new shard count (JOIN/LEAVE) with every queued request id kept in order.

Decode: every slot advances at its own position in ONE batched call (the
reference's ``jax.vmap`` over slots becomes a batch dimension with a
per-row ``cache_index [B]``: a per-row ring-cache write and per-row rope
positions).  As in the reference, prompts are teacher-forced through the
decode step one token at a time, and every slot row decodes each step,
idle ones included; a refilled slot's cache is not cleared (stale ring
entries are masked by position; the recurrent SSM state is not, which
the reference does too: ROADMAP.md §3).

Not ported yet (they raise ``NotImplementedError``): ``priorities > 1``,
``deadline``, ``admission``, ``autoscale`` and ``telemetry``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..dqueue import ElasticDeviceQueue, ServeInvariantError
from ..kernels.backend import resolve_device
from ..obs.trace import span


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle bookkeeping.

    Attributes:
      rid: caller-chosen unique request id (rides the queue as payload).
      prompt: prompt token ids, teacher-forced through the decode path.
      max_new: tokens to generate after the prompt.
      prio: the reference's SLA tier; only tier 0 is served here (the
        tiered mode waits).
      out: generated token ids (filled by the engine).
      done: True once ``max_new`` tokens (or ``max_seq``) were produced.
      enqueue_step: step the request was accepted.
      start_step: step it won a decode slot; -1 while queued.
      finish_step: step it completed; -1 while running.
    """

    rid: int
    prompt: List[int]
    max_new: int = 8
    prio: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    enqueue_step: int = -1
    start_step: int = -1
    finish_step: int = -1


def _not_ported(what: str):
    return NotImplementedError(
        f"ServeEngine({what}) is not ported yet; the port serves FIFO "
        f"admission only (ROADMAP.md, queue 1 item 7)")


class ServeEngine:
    """Continuous-batching serving engine over the Skueue device queue.

    Args:
      model / params: the decode model (:func:`repro_torch.models.
        build_model`) and its parameters, on the engine's device.
      n_shards: request-queue shards (the reference's mesh ``"data"``
        axis).
      max_slots: concurrent decode slots (continuous-batching width).
      max_seq: per-slot sequence capacity.
      queue_cap: per-shard ring capacity of the request queue.
      pipelined: software-pipelined multi-wave bursts (default).
      pool_size: shards available to ``resize`` (default ``n_shards``).
      device: default CUDA; raises where there is none.
      priorities, deadline, telemetry, admission, autoscale: only the
        reference's defaults are ported.

    Raises:
      NotImplementedError: a mode that is not ported yet.
    """

    def __init__(self, model, params, n_shards: int = 1, *,
                 max_slots: int = 4, max_seq: int = 64,
                 queue_cap: int = 256, priorities: int = 1,
                 deadline: bool = False,
                 pipelined: bool = True, telemetry: bool = False,
                 admission=None, autoscale=None,
                 pool_size: Optional[int] = None, device=None):
        for name, on in (("priorities > 1", priorities > 1),
                         ("deadline=True", deadline),
                         ("telemetry=True", telemetry),
                         ("admission=...", admission is not None),
                         ("autoscale=...", autoscale is not None)):
            if on:
                raise _not_ported(name)
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.queue = ElasticDeviceQueue(n_shards, cap=queue_cap,
                                        payload_width=2,
                                        ops_per_shard=max(8, 2 * max_slots),
                                        pipelined=pipelined,
                                        pool_size=pool_size,
                                        device=resolve_device(device))
        self.device = self.queue.device
        self.requests: Dict[int, Request] = {}
        self.slots: List[Optional[int]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int64)
        self.cache = model.init_cache(max_slots, max_seq, device=self.device)
        self.step_no = 0
        self._staged: List[int] = []   # rids submitted but not yet flushed
        self._host_qsize = 0           # host mirror of the device queue size
        self.stats = {"served": 0, "queue_waits": []}

    # ---------------------------------------------------------- frontend ---
    def submit(self, reqs: List[Request]):
        """Stage arrivals for the request queue.  They enter it on the next
        engine step, fused with that step's refill dequeues; a burst larger
        than one wave is chunked across as many waves as needed, all in one
        ``run_waves`` call.

        Raises:
          ValueError: a request with a tier other than 0.
        """
        with span("serve:submit", cat="serve", n=len(reqs),
                  step=self.step_no):
            for r in reqs:
                if r.prio != 0:
                    raise ValueError(f"request {r.rid} prio {r.prio}: this "
                                     f"engine has one tier")
            for r in reqs:
                self.requests[r.rid] = r
                r.enqueue_step = self.step_no
                self._staged.append(r.rid)

    def _queue_wave(self, enq_rids: List[int], n_deq: int) -> List[int]:
        """Run enqueues + dequeues as chunked fused waves; returns the
        granted request ids.  A burst that fits one wave rides the
        narrowest width of the queue's bucket ladder that holds it;
        oversized bursts chunk at the full width."""
        n_ops = len(enq_rids) + n_deq
        if n_ops == 0:
            return []
        q = self.queue
        n_full = q.n_shards * q.L
        n = q.n_shards * q.pick_width(n_ops) if n_ops <= n_full else n_full
        n_waves = -(-n_ops // n)
        # a power of two (extra waves are all-invalid no-ops), as the
        # reference pads it to bound its compiled shapes
        n_waves = 1 << (n_waves - 1).bit_length()
        is_enq = np.zeros((n_waves, n), bool)
        valid = np.zeros((n_waves, n), bool)
        payload = np.zeros((n_waves, n, 2), np.int32)
        j = np.arange(len(enq_rids))
        is_enq.flat[j] = valid.flat[j] = True
        payload.reshape(-1, 2)[j, 0] = enq_rids
        valid.flat[len(enq_rids): n_ops] = True   # dequeue requests
        _, _, dv, dok, _ = q.run_waves(
            *(torch.from_numpy(a).to(self.device)
              for a in (is_enq, valid, payload)))
        dv = q.runtime.to_host(dv).reshape(n_waves * n, 2)
        dok = q.runtime.to_host(dok).reshape(n_waves * n)
        got = [int(x) for x in dv[dok, 0]]
        self._host_qsize += len(enq_rids) - len(got)
        return got

    def _flush_and_refill(self):
        """ONE fused queue dispatch: staged enqueues + free-slot dequeues."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        enq_rids, self._staged = self._staged, []
        with span("serve:refill", cat="serve", step=self.step_no,
                  enq=len(enq_rids), free=len(free)):
            got = self._queue_wave(enq_rids, len(free))
        for slot, rid in zip(free, got):
            r = self.requests[rid]
            r.start_step = self.step_no
            self.stats["queue_waits"].append(r.start_step - r.enqueue_step)
            self.slots[slot] = rid
            self.slot_pos[slot] = 0

    # ----------------------------------------------------------- elastic ---
    def resize(self, n_shards: int) -> dict:
        """Live JOIN/LEAVE of queue shards between engine steps.

        Drains staged submissions into the queue (an enqueue-only burst),
        re-materializes the queue onto ``n_shards`` shards and resumes:
        queued request ids and their FIFO order are kept exactly.  Returns
        the migration stats dict.

        Raises:
          ServeInvariantError: the enqueue-only drain granted a request.
        """
        enq_rids, self._staged = self._staged, []
        got = self._queue_wave(enq_rids, 0)
        if got:
            raise ServeInvariantError(
                "resize drain wave granted requests from an enqueue-only "
                "wave", granted_rids=got, staged=len(enq_rids),
                n_shards_from=self.queue.n_shards, n_shards_to=n_shards,
                host_qsize=self._host_qsize, step=self.step_no,
                trajectory=self.queue.trajectory())
        return self.queue.resize(n_shards)

    # ------------------------------------------------------ observability ---
    def metrics(self) -> dict:
        """Host-side snapshot of the serving fabric: served count, slot
        use, staged count, the queue-depth mirror and the queue's shape
        and occupancy, and admission-wait percentiles (engine steps)."""
        q = self.queue
        occ = q.occupancy()
        waits = self.stats["queue_waits"]
        adm = {"n": len(waits)}
        if waits:
            w = np.asarray(waits, np.float64)
            adm.update(mean=float(w.mean()),
                       p50=float(np.percentile(w, 50)),
                       p99=float(np.percentile(w, 99)))
        return {
            "step": self.step_no,
            "served": self.stats["served"],
            "slots": {"active": sum(s is not None for s in self.slots),
                      "max": self.max_slots},
            "staged": len(self._staged),
            "queue": {"kind": q._kind, "n_shards": q.n_shards,
                      "depth": self._host_qsize,
                      "window_capacity": q.window_capacity(),
                      "occupancy": occ,
                      "headroom": q.window_capacity() - max(occ, default=0),
                      "migrations": len(q.migrations)},
            "admission": adm,
        }

    # ------------------------------------------------------------ decode ---
    def step(self):
        """One engine step: flush + refill in one queue burst, then one
        batched decode in which every slot advances at its own position."""
        self.step_no += 1
        self._flush_and_refill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        toks = np.zeros((self.max_slots, 1), np.int64)
        for i in active:
            r = self.requests[self.slots[i]]
            p = int(self.slot_pos[i])
            if p < len(r.prompt):
                toks[i, 0] = r.prompt[p]
            else:
                toks[i, 0] = r.out[-1] if r.out else r.prompt[-1]
        logits, self.cache = self.model.decode_fn(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.slot_pos).to(self.device))
        nxt = logits.argmax(-1).cpu().numpy()
        for i in active:
            r = self.requests[self.slots[i]]
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(r.prompt):
                r.out.append(int(nxt[i]))
                if (len(r.out) >= r.max_new
                        or self.slot_pos[i] >= self.max_seq - 1):
                    r.done = True
                    r.finish_step = self.step_no
                    self.stats["served"] += 1
                    self.slots[i] = None

    def run_until_drained(self, max_steps: int = 1000) -> bool:
        """Drive steps until everything is served.  Drain detection uses the
        host-side queue-size mirror (no device read between steps)."""
        for _ in range(max_steps):
            self.step()
            if (all(r.done for r in self.requests.values())
                    and not self._staged and self._host_qsize == 0):
                return True
        return False
