"""Fault tolerance: failure injection, restart from a checkpoint, and
shrink-on-failure.

Copy of ``repro/fault/failures.py`` (jax-free there too), over the port's
checkpointer and spans.  Two recovery policies, composable in one loop:

* **checkpoint-restart**: reload the last committed checkpoint and replay
  from its step; works for any failure, costs the replayed steps.
* **shrink-on-failure** (the paper's LEAVE): when the failure names a
  dead shard (:class:`ShardFailure`) and the caller supplies an
  :class:`ElasticPolicy`, the loop LEAVEs that shard (the elastic
  structure re-materializes onto the survivors) and retries the same step
  on the smaller fleet: no replay, no checkpoint round trip.  After
  ``regrow_after`` consecutive healthy steps the policy's ``regrow`` hook
  JOINs a replacement back.

As in the reference, ``steps_replayed`` in the returned accounting is
never raised: a restart's replayed steps show in ``steps_run``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..obs.trace import span


class SimulatedFailure(RuntimeError):
    pass


class ShardFailure(SimulatedFailure):
    """A failure attributable to one shard — eligible for LEAVE instead of
    restart when an :class:`ElasticPolicy` is installed.

    ``shard`` is a MESH INDEX — only stable while the membership never
    changes, which is exactly the assumption elasticity breaks.  Failures
    attributed by hardware (a dead process, a SimRuntime schedule) carry
    ``device_id`` instead: the stable runtime identity, immune to
    the index shift a prior LEAVE causes."""

    def __init__(self, shard: Optional[int], step: int,
                 device_id: Optional[int] = None):
        who = (f"device id {device_id}" if device_id is not None
               else f"shard {shard}")
        super().__init__(f"injected failure of {who} at step {step}")
        self.shard = shard
        self.step = step
        self.device_id = device_id


@dataclasses.dataclass
class FailureInjector:
    """Raises at chosen steps: ``fail_at_steps`` raise plain
    :class:`SimulatedFailure` (whole-job crash); ``shard_fail_at`` maps
    step -> shard MESH INDEX and ``device_fail_at`` maps step -> stable
    DEVICE ID, both raising :class:`ShardFailure` (attributable).  Prefer
    ``device_fail_at`` whenever more than one failure can occur: mesh
    indices shift after every LEAVE, device ids never do."""

    fail_at_steps: tuple = ()
    shard_fail_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    device_fail_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.device_fail_at and ("dev", step) not in self.fired:
            self.fired.add(("dev", step))
            raise ShardFailure(None, step,
                               device_id=self.device_fail_at[step])
        if step in self.shard_fail_at and ("shard", step) not in self.fired:
            self.fired.add(("shard", step))
            raise ShardFailure(self.shard_fail_at[step], step)
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class ElasticPolicy:
    """Shrink-on-failure / regrow-on-recovery hooks for
    :func:`run_with_restarts`.

    ``shrink(state, dead_shard) -> state`` issues the LEAVE (the state
    carrier decides what that means — for an ``ElasticDeviceQueue``-backed
    state it is ``queue.shrink([dead_shard])``).  ``regrow(state) -> state``
    JOINs one replacement shard; it fires after ``regrow_after`` consecutive
    healthy steps while capacity is degraded (0 disables regrowing).

    ``shrink_by_device(state, device_id) -> state`` is the stable-id
    LEAVE: it receives the runtime device id from a
    :class:`ShardFailure` carrying one, and should quarantine the device
    so a later regrow-JOIN cannot resurrect state onto dead hardware."""

    shrink: Callable[[object, int], object]
    regrow: Optional[Callable[[object], object]] = None
    regrow_after: int = 0
    shrink_by_device: Optional[Callable[[object, int], object]] = None


def elastic_queue_policy(queue, regrow_after: int = 0,
                         controller=None) -> ElasticPolicy:
    """An :class:`ElasticPolicy` wired to any elastic queue wrapper
    (``ElasticDeviceQueue`` / ``ElasticDeviceStack`` /
    ``ElasticDevicePriorityQueue`` — all WaveEngine disciplines share the
    same membership surface, so one policy covers every flavor): a
    :class:`ShardFailure` LEAVEs the dead shard out of the queue fabric,
    and recovery JOINs one replacement shard back after ``regrow_after``
    healthy steps.  The training/serving state passes through untouched —
    the queue re-materializes itself.

    Args:
      queue: the elastic wrapper whose membership the policy drives.
      regrow_after: consecutive healthy steps before a replacement JOIN
        (0 disables regrowing).
      controller: an optional
        :class:`~repro_torch.serve.HysteresisController` sharing this queue
        (the autoscaler).  Every failure-LEAVE and regrow-JOIN is
        reported to it as an *external* resize, which resets its
        patience counters and starts its cooldown — so the autoscaler
        does not immediately JOIN back a shard the fault layer removed
        because it died, and does not count the fault layer's membership
        changes as its own decisions.
    """
    def _notify():
        if controller is not None:
            controller.notify_resize(queue.n_shards, external=True)

    def _shrink_dev(state, device_id):
        # stable-id LEAVE: quarantine the dead device in the
        # queue's runtime so the regrow-JOIN below can never resurrect
        # state onto it
        queue.shrink_devices([device_id], quarantine=True)
        _notify()
        return state

    def _shrink(state, shard):
        # a bare mesh index is resolved to the CURRENT shard->device map
        # before the LEAVE mutates it, then handled on the stable-id path
        return _shrink_dev(state, queue.device_ids[shard])

    def _regrow(state):
        queue.grow(1)
        _notify()
        return state

    return ElasticPolicy(
        shrink=_shrink,
        regrow=_regrow if regrow_after > 0 else None,
        regrow_after=regrow_after,
        shrink_by_device=_shrink_dev)


def run_with_restarts(*, init_state: Callable[[], tuple],
                      step_fn: Callable[[tuple, int], tuple],
                      n_steps: int, ckpt_dir, ckpt_every: int = 10,
                      injector: Optional[FailureInjector] = None,
                      elastic: Optional[ElasticPolicy] = None,
                      max_restarts: int = 10, log: Callable = print):
    """Run ``step_fn(state, step) -> state`` for n_steps with checkpointing.

    On a :class:`ShardFailure` with an ``elastic`` policy: LEAVE the dead
    shard and retry the same step on the shrunk fleet (no replay).  On any
    other failure (or without a policy): reload the latest checkpoint and
    resume from its step.  Returns (state, metrics with restart/LEAVE/JOIN
    accounting)."""
    restarts = 0
    metrics = {"restarts": 0, "steps_replayed": 0, "steps_run": 0,
               "leaves": 0, "joins": 0}
    # LEAVEd-but-not-regrown capacity survives checkpoint restarts: the
    # elastic state (e.g. a shrunk ElasticDeviceQueue captured by the
    # policy hooks) lives outside the checkpointed tree, so forgetting the
    # deficit on restart would permanently disable regrow.
    degraded = 0
    while True:
        start = latest_step(ckpt_dir)
        state = init_state()
        step0 = 0
        if start is not None:
            with span("checkpoint:restore", cat="checkpoint", step=start):
                host, manifest = load_checkpoint(ckpt_dir, start, state)
            state = host
            step0 = int(manifest["step"])
            log(f"[fault] restored step {step0}")
        try:
            step = step0
            healthy = 0    # consecutive failure-free steps
            while step < n_steps:
                try:
                    if injector is not None:
                        injector.maybe_fail(step)
                    state = step_fn(state, step)
                except ShardFailure as e:
                    if elastic is None:
                        raise
                    log(f"[fault] {e}; LEAVE instead of restart")
                    dev = getattr(e, "device_id", None)
                    with span("fault:leave", cat="membership",
                              shard=e.shard, device=dev, step=step):
                        if dev is not None \
                                and elastic.shrink_by_device is not None:
                            state = elastic.shrink_by_device(state, dev)
                        elif dev is not None:
                            raise ValueError(
                                f"ShardFailure carries device_id={dev} but "
                                "the ElasticPolicy has no shrink_by_device "
                                "hook — use fault.elastic_queue_policy or "
                                "supply one") from e
                        else:
                            state = elastic.shrink(state, e.shard)
                    metrics["leaves"] += 1
                    degraded += 1
                    healthy = 0
                    continue  # retry the SAME step on the smaller fleet
                metrics["steps_run"] += 1
                step += 1
                healthy += 1
                if step % ckpt_every == 0 or step == n_steps:
                    with span("checkpoint:save", cat="checkpoint",
                              step=step):
                        save_checkpoint(ckpt_dir, step, state)
                if (elastic is not None and degraded > 0
                        and elastic.regrow is not None
                        and elastic.regrow_after > 0
                        and healthy >= elastic.regrow_after):
                    log("[fault] recovered; JOIN of a replacement shard")
                    with span("fault:join", cat="membership", step=step):
                        state = elastic.regrow(state)
                    metrics["joins"] += 1
                    degraded -= 1
                    healthy = 0
            metrics["restarts"] = restarts
            return state, metrics
        except SimulatedFailure as e:
            restarts += 1
            log(f"[fault] {e}; restarting ({restarts})")
            if restarts > max_restarts:
                raise
