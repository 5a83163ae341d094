"""Continuous-batching serving engine fed by the Skueue request queue.

Counterpart of ``repro/serve/engine.py``.  Requests are enqueued into an
elastic device queue (payload = request id) and admitted to decode slots
in the queue's sequentially consistent order.  ``submit`` stages arrivals
host-side; each engine step flushes the staged enqueues and the free
slots' dequeues as ONE chunked burst of fused queue waves
(``run_waves``), at the narrowest width of the queue's bucket ladder that
holds them, the wave count padded to a power of two.  The engine mirrors
the queue size on the host, so draining never reads device state between
steps.  ``resize`` drains staged submissions into the queue and
re-materializes it onto a new shard count (JOIN/LEAVE) with every queued
request id kept in order.

The admission order is the queue's:

* FIFO (the default): an :class:`~repro_torch.dqueue.ElasticDeviceQueue`;
* SLA tiers (``priorities=P``): an
  :class:`~repro_torch.dqueue.ElasticDevicePriorityQueue`, tier 0 first,
  ``relaxation=k`` forwarded; ``tier_wait_stats`` reports each tier's
  waits;
* earliest deadline first (``deadline=True``): an
  :class:`~repro_torch.dqueue.ElasticDeviceSeapQueue` keyed by the
  request's deadline step, its directory seeded on a step grid over
  ``deadline_horizon``, EDF at the directory's bucket granularity;
  ``deadline_stats`` reports the misses.

``admission=`` installs a policy (:mod:`repro_torch.serve.admission`:
shed, defer or degrade) that ``submit`` consults against the queue's
pressure before staging anything; deferred requests wait in a bounded
host-side spill buffer that drains ahead of new arrivals.  ``autoscale=``
takes a :class:`~repro_torch.serve.HysteresisController` that turns
sustained pressure into ``resize`` calls.

Decode: every slot advances at its own position in ONE batched call (the
reference's ``jax.vmap`` over slots becomes a batch dimension with a
per-row ``cache_index [B]``: a per-row ring-cache write and per-row rope
positions).  As in the reference, prompts are teacher-forced through the
decode step one token at a time, and every slot row decodes each step,
idle ones included; a refilled slot's cache is not cleared (stale ring
entries are masked by position; the recurrent SSM state is not, which
the reference does too: ROADMAP.md §3).

Observability: ``telemetry=True`` turns on Wavescope for the request
queue: every queue wave writes a row into the queue's device metrics
ring (no extra exchange), drained host-side at burst boundaries into its
flight recorder; :meth:`ServeEngine.metrics` then carries the recent wave
summaries under ``"waves"``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..dqueue import (ElasticDevicePriorityQueue, ElasticDeviceQueue,
                      ElasticDeviceSeapQueue, ServeInvariantError)
from ..kernels.backend import resolve_device
from ..obs.trace import span
from .admission import AdmissionRejected, PressureSignal, resolve_policy


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle bookkeeping.

    Attributes:
      rid: caller-chosen unique request id (rides the queue as payload).
      prompt: prompt token ids, teacher-forced through the decode path.
      max_new: tokens to generate after the prompt.
      prio: SLA tier on ``priorities > 1`` engines (0 = most urgent; the
        degrade admission policy may raise it).
      deadline: absolute engine step to start by on EDF engines (the
        degrade policy may extend it); -1 = unset.
      out: generated token ids (filled by the engine).
      done: True once ``max_new`` tokens (or ``max_seq``) were produced.
      enqueue_step: step the request was accepted (staged or deferred).
      start_step: step it won a decode slot; -1 while queued.
      finish_step: step it completed; -1 while running.
    """

    rid: int
    prompt: List[int]
    max_new: int = 8
    prio: int = 0
    deadline: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    enqueue_step: int = -1
    start_step: int = -1
    finish_step: int = -1


class ServeEngine:
    """Continuous-batching serving engine over the Skueue device queue.

    Args:
      model / params: the decode model (:func:`repro_torch.models.
        build_model`) and its parameters, on the engine's device.
      n_shards: request-queue shards (the reference's mesh ``"data"``
        axis).
      max_slots: concurrent decode slots (continuous-batching width).
      max_seq: per-slot sequence capacity.
      queue_cap: per-shard ring capacity of the request queue (per tier
        or bucket).
      priorities: > 1 swaps in the priority queue with that many SLA
        tiers (exclusive with ``deadline``).
      relaxation: Skeap's bounded tier relaxation (tiers only).
      deadline: True swaps in the Seap queue for EDF admission.
      n_buckets / deadline_horizon: the Seap directory's shape (EDF only).
      pipelined: software-pipelined multi-wave bursts (default).
      telemetry: Wavescope device metrics on the request queue, and the
        ``"waves"`` section of :meth:`metrics`.
      flight_k: the flight recorder's depth (wave summaries kept).
      admission: None, a policy name ("shed" / "defer" / "degrade"), or
        an :class:`~repro_torch.serve.admission.AdmissionPolicy`,
        consulted by :meth:`submit` before staging.
      spill_cap: bound of the defer policy's host-side spill buffer.
      autoscale: a :class:`~repro_torch.serve.HysteresisController`
        driving :meth:`resize` from sustained pressure; its
        ``max_shards`` defaults to the queue's shard pool.
      pool_size: shards available to ``resize`` (default ``n_shards``).
      device: default CUDA; raises where there is none.
      runtime: a :class:`~repro_torch.runtime.LocalRuntime`,
        :class:`~repro_torch.runtime.SimRuntime` or
        :class:`~repro_torch.runtime.DistributedRuntime` owning the
        queue's shard pool and device (exclusive with
        ``pool_size``/``device``).  On a multi-process runtime every
        process builds the engine with the same arguments, submits the
        same requests and decodes on its own replica of the model, as in
        the reference; the queue's shards are split over the processes
        and each granted request id is gathered to all of them.

    Raises:
      ValueError: incompatible discipline flags or unknown policy name.
    """

    def __init__(self, model, params, n_shards: int = 1, *,
                 max_slots: int = 4, max_seq: int = 64,
                 queue_cap: int = 256, priorities: int = 1,
                 relaxation: int = 0, deadline: bool = False,
                 n_buckets: int = 8, deadline_horizon: int = 64,
                 pipelined: bool = True, telemetry: bool = False,
                 flight_k: int = 16, admission=None, spill_cap: int = 64,
                 autoscale=None, pool_size: Optional[int] = None,
                 device=None, runtime=None):
        if deadline and priorities > 1:
            raise ValueError("deadline=True (EDF via the Seap queue) and "
                             "priorities > 1 (SLA tiers) are exclusive "
                             "admission disciplines")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.priorities = priorities
        self.deadline = deadline
        self.telemetry = bool(telemetry)
        kw = dict(cap=queue_cap, payload_width=2,
                  ops_per_shard=max(8, 2 * max_slots), pipelined=pipelined,
                  metrics=telemetry, flight_k=flight_k, pool_size=pool_size,
                  device=resolve_device(device) if runtime is None else device)
        if runtime is not None:
            kw["runtime"] = runtime
        if deadline:
            # the directory is seeded on a step grid over the deadline
            # horizon, and splits trigger at about one refill's worth of
            # waiting requests
            grid = max(1, deadline_horizon // n_buckets)
            self.queue = ElasticDeviceSeapQueue(
                n_shards, n_buckets=n_buckets,
                split_occupancy=max(1, 2 * max_slots),
                seed_bounds=[i * grid for i in range(1, n_buckets)], **kw)
        elif priorities > 1:
            self.queue = ElasticDevicePriorityQueue(
                n_shards, n_prios=priorities, relaxation=relaxation, **kw)
        else:
            self.queue = ElasticDeviceQueue(n_shards, **kw)
        self.device = self.queue.device
        self.requests: Dict[int, Request] = {}
        self.slots: List[Optional[int]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int64)
        self.cache = model.init_cache(max_slots, max_seq, device=self.device)
        self.step_no = 0
        self._staged: List[int] = []   # rids submitted but not yet flushed
        self._host_qsize = 0           # host mirror of the device queue size
        self.stats = {"served": 0, "queue_waits": [],
                      "queue_waits_by_prio": {p: [] for
                                              p in range(priorities)},
                      "deadline_lateness": []}
        # the backpressure control plane
        self.admission = resolve_policy(admission)
        self.spill_cap = int(spill_cap)
        self._spill: deque = deque()   # deferred Requests, oldest first
        self.autoscale = autoscale
        if autoscale is not None and autoscale.cfg.max_shards is None:
            autoscale.cfg.max_shards = self.queue.pool_size
        self._overloaded = False       # shed/defer seen since last tick
        self._in_autoscale = False     # the resize() call is the controller's
        self.admission_stats = {"offered": 0, "admitted": 0, "shed": 0,
                                "deferred": 0, "degraded": 0,
                                "spill_peak": 0, "decide_us": []}

    # ---------------------------------------------------------- frontend ---
    def submit(self, reqs: List[Request], prio: Optional[int] = None,
               deadline: Optional[int] = None):
        """Stage arrivals for the request queue.  They enter it on the next
        engine step, fused with that step's refill dequeues; a burst larger
        than one wave is chunked across as many waves as needed, all in one
        ``run_waves`` call.

        With ``priorities > 1``, ``prio`` (or each request's ``.prio``)
        selects the SLA tier.  With ``deadline=True`` on the engine,
        ``deadline`` (steps from now) or each request's ``.deadline`` (an
        absolute engine step) is the EDF key.  With an admission policy,
        the batch is first decided against the queue's pressure: what fits
        is staged, the defer policy spills the rest host-side, and
        anything rejected raises, AFTER the fitting part was staged.

        Raises:
          ValueError: a tier out of range or a missing deadline.
          AdmissionRejected: the policy rejected part of the batch (or the
            spill buffer was full); ``err.shed`` holds the untouched,
            resubmittable requests.
        """
        with span("serve:submit", cat="serve", n=len(reqs),
                  step=self.step_no):
            self._submit(reqs, prio, deadline)

    def _submit(self, reqs: List[Request], prio: Optional[int],
                deadline: Optional[int]):
        for r in reqs:
            if prio is not None:
                r.prio = prio
            if not 0 <= r.prio < self.priorities:
                raise ValueError(f"request {r.rid} prio {r.prio} outside "
                                 f"[0, {self.priorities})")
            if self.deadline:
                if deadline is not None:
                    r.deadline = self.step_no + deadline
                if r.deadline < 0:
                    raise ValueError(f"request {r.rid} needs a deadline "
                                     "(engine runs EDF admission)")
        if self.admission is None:
            for r in reqs:
                self._accept(r, stage=True)
            return
        t0 = time.perf_counter()
        sig = self._pressure_signal()
        dec = self.admission.decide(list(reqs), sig)
        st = self.admission_stats
        st["decide_us"].append((time.perf_counter() - t0) * 1e6)
        st["offered"] += len(reqs)
        st["admitted"] += len(dec.admit)
        st["deferred"] += len(dec.defer)
        st["degraded"] += dec.degraded
        for r in dec.admit:
            self._accept(r, stage=True)
        for r in dec.defer:
            self._accept(r, stage=False)
            self._spill.append(r)
        st["spill_peak"] = max(st["spill_peak"], len(self._spill))
        if dec.shed or dec.defer or dec.degraded:
            self._overloaded = True
            self.queue.recorder.record({
                "event": "admission", "step": self.step_no,
                "policy": self.admission.name, "shed": len(dec.shed),
                "deferred": len(dec.defer), "degraded": dec.degraded,
                "occ": list(sig.occupancy)})
        if dec.shed:
            st["shed"] += len(dec.shed)
            backlog = len(dec.shed) + len(self._spill)
            raise AdmissionRejected(
                self.admission.name,
                "spill-overflow" if dec.spill_overflow else "shed",
                dec.shed, admitted=len(dec.admit),
                deferred=len(dec.defer), degraded=dec.degraded,
                pressure=sig.snapshot(),
                retry_after=-(-backlog // max(1, self.max_slots)))

    def _accept(self, r: Request, *, stage: bool):
        """Register an admitted request; stage it for the next flush (or
        leave it to the spill buffer when ``stage`` is False)."""
        self.requests[r.rid] = r
        r.enqueue_step = self.step_no
        if stage:
            self._staged.append(r.rid)

    # ------------------------------------------------------- backpressure ---
    def _pressure_signal(self) -> PressureSignal:
        """Snapshot the queue and host pressure for an admission decision:
        occupancy and the Seap directory from the elastic wrapper's
        pressure API (a small host read between bursts, no wave), staged
        and spill counts from host bookkeeping."""
        q = self.queue
        occ = q.occupancy()
        staged = [0] * len(occ)
        window_order = None
        window_lo = None
        if self.deadline:
            entries = q.directory()       # (lo, bucket) in key order
            los = [lo for lo, _ in entries]
            ids = [b for _, b in entries]
            window_order = ids
            window_lo = {b: lo for lo, b in entries}

            def window_of(r, _los=los, _ids=ids):
                return _ids[max(0, bisect.bisect_right(_los,
                                                       r.deadline) - 1)]
        elif self.priorities > 1:
            def window_of(r):
                return r.prio
        else:
            def window_of(r):
                return 0
        for rid in self._staged:
            staged[window_of(self.requests[rid])] += 1
        late = self.stats["deadline_lateness"][-128:]
        p99 = (float(np.percentile(np.asarray(late, np.float64), 99))
               if late else 0.0)
        return PressureSignal(
            capacity=q.window_capacity(), occupancy=occ, staged=staged,
            spill=len(self._spill), spill_cap=self.spill_cap,
            step=self.step_no,
            mode=("edf" if self.deadline
                  else "tiers" if self.priorities > 1 else "fifo"),
            lateness_p99=p99, drain_per_step=self.max_slots,
            window_of=window_of, window_order=window_order,
            window_lo=window_lo)

    def _drain_spill(self):
        """Re-offer deferred requests ahead of new arrivals, as far as the
        current headroom allows (oldest first; the rest keep waiting)."""
        if not self._spill:
            return
        sig = self._pressure_signal()
        keep: deque = deque()
        front: List[int] = []
        while self._spill:
            r = self._spill.popleft()
            w = sig.window_of(r)
            if sig.headroom(w) > 0:
                sig.take(w)
                front.append(r.rid)
            else:
                keep.append(r)
        self._spill = keep
        self._staged = front + self._staged

    def _autoscale_tick(self):
        """One controller observation; runs the resize it decides.  The
        utilization counts the hottest window's occupancy plus everything
        still host-side (staged and spilled)."""
        q = self.queue
        cap = q.window_capacity()
        occ = q.occupancy()
        backlog = max(occ, default=0) + len(self._staged) + len(self._spill)
        util = backlog / cap if cap else 1.0
        target = self.autoscale.observe(util, q.n_shards,
                                        overloaded=self._overloaded)
        self._overloaded = False
        if target is None or target == q.n_shards:
            return
        with span("serve:autoscale", cat="serve", step=self.step_no,
                  target=target):
            self._in_autoscale = True
            try:
                self.resize(target)
            finally:
                self._in_autoscale = False
        self.autoscale.notify_resize(target)
        q.recorder.record({"event": "autoscale", "step": self.step_no,
                           "n_shards": target, "occ": occ})

    # ------------------------------------------------------------- queue ---
    def _queue_wave(self, enq_rids: List[int], n_deq: int) -> List[int]:
        """Run enqueues + dequeues as chunked fused waves; returns the
        granted request ids.  A burst that fits one wave rides the
        narrowest width of the queue's bucket ladder that holds it;
        oversized bursts chunk at the full width.  Tier and EDF engines
        send each enqueue's tier or deadline as its key."""
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
        ops = [is_enq, valid, payload]
        if self.deadline or self.priorities > 1:
            key = np.zeros((n_waves, n), np.int32)
            key.flat[j] = [self.requests[rid].deadline if self.deadline
                           else self.requests[rid].prio for rid in enq_rids]
            ops.insert(2, key)
        # the elastic wrapper places each array (this process's shards'
        # rows of it on a multi-process runtime)
        out = q.run_waves(*(torch.from_numpy(a) for a in ops))
        k = q.inner.disc.n_disp_outs             # dequeued values follow
        dv, dok = out[k], out[k + 1]
        dv = q.runtime.to_host(dv, q.shards, 1).reshape(n_waves * n, 2)
        dok = q.runtime.to_host(dok, q.shards, 1).reshape(n_waves * n)
        got = [int(x) for x in dv[dok, 0]]
        self._host_qsize += len(enq_rids) - len(got)
        return got

    def _flush_and_refill(self):
        """ONE fused queue dispatch: staged enqueues + free-slot dequeues.
        Deferred (spilled) requests drain first, ahead of new arrivals."""
        self._drain_spill()
        free = [i for i, s in enumerate(self.slots) if s is None]
        enq_rids, self._staged = self._staged, []
        with span("serve:refill", cat="serve", step=self.step_no,
                  enq=len(enq_rids), free=len(free)):
            got = self._queue_wave(enq_rids, len(free))
        for slot, rid in zip(free, got):
            r = self.requests[rid]
            r.start_step = self.step_no
            self.stats["queue_waits"].append(r.start_step - r.enqueue_step)
            self.stats["queue_waits_by_prio"][r.prio].append(
                r.start_step - r.enqueue_step)
            if self.deadline and r.deadline >= 0:
                self.stats["deadline_lateness"].append(
                    r.start_step - r.deadline)
            self.slots[slot] = rid
            self.slot_pos[slot] = 0

    def _pending_by_prio(self) -> Dict[int, int]:
        """Submitted-but-not-yet-admitted request count per tier."""
        pending = {p: 0 for p in range(self.priorities)}
        for r in self.requests.values():
            if r.start_step < 0 and not r.done:
                pending[r.prio] += 1
        return pending

    def tier_wait_stats(self) -> Dict[int, dict]:
        """Per-tier admission latency (engine steps from submit to slot):
        count / mean / p50 / p99 plus the tier's ``pending`` (submitted,
        never admitted) count.  Every configured tier gets a row, a
        starved one ``{"n": 0, "pending": k}``."""
        pending = self._pending_by_prio()
        out = {}
        for p in range(self.priorities):
            waits = self.stats["queue_waits_by_prio"].get(p, [])
            row = {"n": len(waits), "pending": pending[p]}
            if waits:
                w = np.asarray(waits, np.float64)
                row.update(mean=float(w.mean()),
                           p50=float(np.percentile(w, 50)),
                           p99=float(np.percentile(w, 99)))
            out[p] = row
        return out

    def deadline_stats(self) -> dict:
        """EDF admission outcome (``deadline=True`` engines): admissions,
        misses (started after the deadline step), miss rate, lateness
        percentiles, and the still-pending count."""
        late = np.asarray(self.stats["deadline_lateness"], np.float64)
        missed = int((late > 0).sum()) if late.size else 0
        out = {"n": int(late.size), "missed": missed,
               "miss_rate": missed / late.size if late.size else 0.0,
               "pending": sum(self._pending_by_prio().values())}
        if late.size:
            out.update(lateness_mean=float(late.mean()),
                       lateness_p99=float(np.percentile(late, 99)),
                       lateness_max=float(late.max()))
        return out

    # ----------------------------------------------------------- elastic ---
    def resize(self, n_shards: int) -> dict:
        """Live JOIN/LEAVE of queue shards between engine steps.

        Drains staged submissions into the queue (an enqueue-only burst),
        re-materializes the queue onto ``n_shards`` shards and resumes:
        queued request ids and their order are kept exactly.  A resize
        the autoscaler did not decide resets the controller's counters.
        Returns the migration stats dict.

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
        stats = self.queue.resize(n_shards)
        if self.autoscale is not None and not self._in_autoscale:
            self.autoscale.notify_resize(n_shards, external=True)
        return stats

    # ------------------------------------------------------ observability ---
    def metrics(self) -> dict:
        """Host-side snapshot of the serving fabric: served count, slot
        use, staged count, the queue-depth mirror and the queue's shape
        and occupancy, admission-wait percentiles (engine steps), and,
        where configured, the admission policy's counters, the
        autoscaler's state, per-tier waits and the deadline outcome.
        With ``telemetry=True`` it also drains the queue's metrics ring
        into the flight recorder and attaches the recent wave summaries
        under ``"waves"`` (a burst-boundary host read, no exchange).
        Feed it to :func:`repro_torch.obs.to_json` or
        :func:`~repro_torch.obs.to_prometheus`."""
        q = self.queue
        occ = q.occupancy()
        snap = {
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
        }
        if self.admission is not None:
            st = self.admission_stats
            ac = {"policy": self.admission.name,
                  "offered": st["offered"], "admitted": st["admitted"],
                  "shed": st["shed"], "deferred": st["deferred"],
                  "degraded": st["degraded"],
                  "spill": len(self._spill), "spill_cap": self.spill_cap,
                  "spill_peak": st["spill_peak"]}
            if st["decide_us"]:
                d = np.asarray(st["decide_us"], np.float64)
                ac.update(decide_us_mean=float(d.mean()),
                          decide_us_p99=float(np.percentile(d, 99)))
            snap["admission_control"] = ac
        if self.autoscale is not None:
            snap["autoscale"] = self.autoscale.snapshot()
        waits = self.stats["queue_waits"]
        adm = {"n": len(waits)}
        if waits:
            w = np.asarray(waits, np.float64)
            adm.update(mean=float(w.mean()),
                       p50=float(np.percentile(w, 50)),
                       p99=float(np.percentile(w, 99)))
        snap["admission"] = adm
        if self.priorities > 1:
            snap["tiers"] = self.tier_wait_stats()
        if self.deadline:
            snap["deadline"] = self.deadline_stats()
        if self.telemetry:
            q._drain_telemetry()
            snap["waves"] = q.trajectory()
        return snap

    # ------------------------------------------------------------ decode ---
    def step(self):
        """One engine step: flush + refill in one queue burst, one
        autoscale tick when ``autoscale=`` is set (it may run a resize),
        then one batched decode in which every slot advances at its own
        position."""
        self.step_no += 1
        self._flush_and_refill()
        if self.autoscale is not None:
            self._autoscale_tick()
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
                    and not self._staged and not self._spill
                    and self._host_qsize == 0):
                return True
        return False
