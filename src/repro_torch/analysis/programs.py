"""The wave-program registry: every device wave program the port ships,
with its declared collective budget and what it holds in place.

Counterpart of ``repro/analysis/programs.py:102-247``, with the
reference's program names.  A reference row is a jitted entry point,
lowered and compiled; a row here is one call of the port's entry point
on staged ops, counted through the runtime seam (:mod:`.seam`).  The
budgets are dynamic counts of one call, each in place of the reference
row it cites:

* a step: exactly 2 exchanges (request + reply; the reference's
  ``_wave_budget(..., burst=False)``: exactly 2 ``all-to-all``);
* a sequential K-wave burst: exactly 2K (the reference's scanned body:
  exactly 2);
* a pipelined K-wave burst: exactly K + 1 (request_k ‖ reply_{k-1} in one
  exchange, a reply-only epilogue; the reference: at most 2 in its
  scanned body);
* the seed wave (``DeviceQueue(fused=False)``, ``_legacy_wave``,
  ``repro/dqueue/device_queue.py:267``): exactly 5
  (``LEGACY_QUEUE_STEP``);
* a migration: exactly 1 (``MIGRATION_BUDGET``).

The reference's ``collective-permute``, ``all-reduce`` and
``all-gather`` caps of the FIFO hypercube scan, the stack's ticket fold
and the replicated tier serve have no counterpart: on one device every
scan runs over the whole flat wave, with no collective.  Gathers are
the port's own numbers, read from the callers of ``Runtime.gather``
(``runtime/local.py:40``, ``runtime/distributed.py:226,253``):

* ``Discipline.gather_ops`` (``dqueue/wave_engine.py``), the wave's op
  descriptors, once a wave, only on a multi-process runtime;
* ``WaveEngine.drain_metrics``, once a drain on a multi-process runtime
  (a drain is not part of any program here);
* ``DistributedRuntime.to_host`` with a shard list and ``host_reduce``:
  a migration's moved/lost read, once a migration on a multi-process
  runtime.

So every program here, on one process, makes exactly 0 gathers; on P > 1
processes a step or seed wave would make 1, a K-wave burst K, a
migration 1.

Telemetry (``[obs]``) and narrower waves (``[compact:wN]``, at every
narrower width of ``wave_engine.bucket_ladder(L)``) keep the budgets of
their plain twins.  The two runtime twins are built through
:class:`~repro_torch.runtime.SimRuntime`, the port's other one-process
runtime (the reference builds them through its ``LocalRuntime`` handle
where the rest uses a bare mesh; here every structure already runs on a
``LocalRuntime``).  At the reference's shape (L = 2, ladder {1, 2}) the
registry holds 31 wave programs and 4 migrations, 35 in all.

The narrower-wave programs also check their answers: run on a device
other than the CPU, the last call of each is replayed on the CPU from
the same state and ops (:func:`cpu_replay`), and every output and state
field must agree bit for bit (a violation of the port's own rule
``cpu_replay`` otherwise).  The other programs' answers are held to the
CPU by the port's other card checks; these widths run nowhere else.

Held in place: each wave program holds the store tensors of its state
(two for every discipline) and, with the metrics ring, the ring's
``rows``.  The reference donates every leaf of the state (4, or 8 for
Seap; + the ring's ``count`` and ``rows``); the port leaves out the
interval carry (``first``/``last``, ``firsts``/``lasts``, Seap's
directory ``lo``/``active``/``key_lo``/``key_hi``) and the ring's
``count``: small tensors the wave replaces (``wave_engine.py``, State),
never copies of the store.  A migration holds nothing: its two old store
tensors must be released (the reference donates the same two).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .budgets import CollectiveBudget

# the state fields each discipline holds in place
STORE_FIELDS = {"queue": ("store_vals", "store_full"),
                "stack": ("vals", "ticks"),
                "priority": ("store_vals", "store_full"),
                "seap": ("store_vals", "store_full")}
KINDS = ("queue", "stack", "priority", "seap")
# slots a shard of each discipline holds (the reference's cap 16)
CAPS = dict.fromkeys(KINDS, 16)


@dataclass
class ProgramSpec:
    """One entry-point call under analysis.

    ``prepare()`` stages one call's ops on the device and returns them;
    ``run(args)`` makes the call (threading the structure's state);
    ``stores()`` returns the tensors the call must hold in place (or,
    with ``release``, must release)."""
    name: str
    runtime: Any
    budget: CollectiveBudget
    prepare: Callable[[], tuple]
    run: Callable[[tuple], None]
    stores: Callable[[], Dict[str, torch.Tensor]]
    held: int                        # tensors held in place
    donated_leaves: int              # the reference's donated leaves
    left_out: str                    # why the other leaves are not held
    release: bool = False            # a migration: the stores must die
    # given one call's args, before the call: a check to run after it
    # that replays the call on the CPU (see :func:`cpu_replay`)
    replay: Optional[Callable[[tuple], Callable[[], List[str]]]] = None
    meta: Dict[str, Any] = field(default_factory=dict)


def wave_budget(*, waves: int = 1, burst: bool = False,
                pipelined: bool = False, legacy: bool = False
                ) -> CollectiveBudget:
    """One call's exact budget on one process: 2 exchanges a step, 2K a
    sequential K-wave burst, K + 1 a pipelined one, 5 a seed wave; no
    gather."""
    ex = (5 * waves if legacy else waves + 1 if burst and pipelined
          else 2 * waves)
    return CollectiveBudget(exact={"exchange": ex, "gather": 0})


MIGRATION_BUDGET = CollectiveBudget(exact={"exchange": 1, "gather": 0})


class _Ops:
    """Seeded op batches of one discipline: ``(is_x, valid[, prio |
    key], payload)`` as host arrays, staged on ``device`` per call."""

    def __init__(self, kind: str, W: int, n_prios: int, device, seed: int):
        self.kind, self.W, self.n_prios = kind, W, n_prios
        self.device = device
        self.rng = np.random.default_rng(seed)

    def __call__(self, n: int, K: Optional[int] = None) -> tuple:
        rng = self.rng
        shape = (n,) if K is None else (K, n)
        valid = rng.random(shape) < 0.9
        if self.kind == "stack":
            # push waves, then pop waves: randomly interleaved full-width
            # waves overflow a slot's depth (dqueue/device_queue.py)
            is_x = np.ones(shape, bool)
            if K is not None and K > 1:
                is_x[K - K // 2:] = False
        else:
            is_x = rng.random(shape) < 0.5
        ops = [is_x, valid]
        if self.kind == "priority":
            ops.append(rng.integers(0, self.n_prios, shape, dtype=np.int32))
        elif self.kind == "seap":
            ops.append(rng.integers(-2 ** 31, 2 ** 31, shape,
                                    dtype=np.int64).astype(np.int32))
        ops.append(rng.integers(0, 2 ** 31, shape + (self.W,),
                                dtype=np.int64).astype(np.int32))
        return tuple(torch.from_numpy(x).to(self.device) for x in ops)


class _Threaded:
    """A structure and its state, threaded through its calls; ``twin``
    builds the same structure on the CPU."""

    def __init__(self, q, kind: str, obs: bool = False,
                 twin: Optional[Callable[[], Any]] = None):
        self.q, self.kind, self.obs, self.twin = q, kind, obs, twin
        self.state = q.init_state()
        self.outs: tuple = ()

    def call(self, method: str, args: tuple) -> None:
        res = getattr(self.q, method)(self.state, *args)
        self.state, self.outs = res[0], res[1:]

    def stores(self) -> Dict[str, torch.Tensor]:
        d = {f: getattr(self.state, f) for f in STORE_FIELDS[self.kind]}
        if self.obs:
            d["metrics.rows"] = self.q.engine._mstate.rows
        return d

    def leaves(self) -> int:
        """The reference's donated leaves: every state leaf, and the
        ring's two with telemetry on."""
        return len(self.state) + (2 if self.obs else 0)

    def left_out(self) -> str:
        kept = set(STORE_FIELDS[self.kind])
        carry = [f for f in self.state._fields if f not in kept]
        s = f"{', '.join(carry)}: the carry, replaced each wave"
        return s + ("; metrics.count: a 0-d counter" if self.obs else "")


def cpu_replay(t: _Threaded, method: str, args: tuple
               ) -> Callable[[], List[str]]:
    """Copy ``t``'s state and one call's ``args`` to the CPU now, before
    the call; the returned check, run after the call, makes the same call
    on ``t.twin()`` (the same structure on the CPU) and names each output
    and state field whose value differs from the call's (none: the two
    agree bit for bit).  A store's junk slot (its last along dim 1) takes
    the writes of inactive rows in no fixed order and is left out."""
    cpu = torch.device("cpu")
    state = type(t.state)(*(x.to(cpu, copy=True) for x in t.state))
    args = tuple(a.to(cpu, copy=True) for a in args)

    def check() -> List[str]:
        res = getattr(t.twin(), method)(state, *args)
        stores = STORE_FIELDS[t.kind]
        pairs = [(f"out[{i}]", a, b) for i, (a, b) in
                 enumerate(zip(t.outs, res[1:]))]
        pairs += [(f, *((x[:, :-1] for x in (a, b)) if f in stores
                        else (a, b)))
                  for f, a, b in zip(t.state._fields, t.state, res[0])]
        return [name for name, a, b in pairs
                if not torch.equal(a.cpu(), b)]
    return check


def _makers(device, caps: dict, L: int, W: int, n_prios: int,
            n_buckets: int, slot_depth: int, relaxation: int):
    from ..dqueue import (DevicePriorityQueue, DeviceQueue, DeviceSeapQueue,
                          DeviceStack)

    def on(kw):          # the device, unless a runtime is given
        return {"device": device, **kw}
    return {
        "queue": lambda n, pipe, obs=False, **kw: DeviceQueue(
            n, cap=caps["queue"], payload_width=W, ops_per_shard=L,
            pipelined=pipe, metrics=obs, **on(kw)),
        "stack": lambda n, pipe, obs=False, **kw: DeviceStack(
            n, cap=caps["stack"], payload_width=W, ops_per_shard=L,
            slot_depth=slot_depth, pipelined=pipe, metrics=obs, **on(kw)),
        "priority": lambda n, pipe, obs=False, **kw: DevicePriorityQueue(
            n, n_prios=n_prios, cap=caps["priority"], payload_width=W,
            ops_per_shard=L, relaxation=relaxation, pipelined=pipe,
            metrics=obs, **on(kw)),
        "seap": lambda n, pipe, obs=False, **kw: DeviceSeapQueue(
            n, n_buckets=n_buckets, cap=caps["seap"], payload_width=W,
            ops_per_shard=L, pipelined=pipe, metrics=obs, **on(kw)),
    }


def _wave_spec(name, t: _Threaded, method: str, ops: _Ops, n: int,
               K: Optional[int], budget: CollectiveBudget,
               meta: dict, replay: bool = False) -> ProgramSpec:
    return ProgramSpec(
        name, t.q.runtime, budget, prepare=lambda: ops(n, K),
        run=lambda args: t.call(method, args), stores=t.stores,
        held=len(t.stores()), donated_leaves=t.leaves(),
        left_out=t.left_out(),
        replay=(lambda args: cpu_replay(t, method, args)) if replay
        else None,
        meta={**meta, "waves": K or 1, "width": n // t.q.n_shards})


def build_programs(n_shards: int = 8, L: int = 2, W: int = 2, K: int = 3,
                   device="cuda", *, n_prios: int = 3, n_buckets: int = 4,
                   slot_depth: int = 4, caps: Dict[str, int] = CAPS,
                   relaxation: int = 0) -> List[ProgramSpec]:
    """Every wave program at ``n_shards`` shards of width ``L``, bursts of
    ``K`` waves, ``W``-word payloads on ``device``.  ``caps`` gives the
    slots a shard of each discipline holds (``{"queue": 65536, ...}``);
    ``relaxation`` applies to the priority programs (0: strict)."""
    from ..dqueue import DeviceQueue
    from ..dqueue.wave_engine import bucket_ladder
    from ..runtime import SimRuntime

    make, on_cpu = (_makers(d, caps, L, W, n_prios, n_buckets, slot_depth,
                            relaxation) for d in (device, "cpu"))
    n = n_shards * L
    step_b = wave_budget()
    seq_b = wave_budget(waves=K, burst=True)
    pipe_b = wave_budget(waves=K, burst=True, pipelined=True)
    specs: List[ProgramSpec] = []
    for i, kind in enumerate(KINDS):
        ops = _Ops(kind, W, n_prios, device, seed=i)
        meta = {"discipline": kind}
        if kind == "priority":
            meta["relaxation"] = relaxation
        seq, pipe = (_Threaded(make[kind](n_shards, p), kind,
                               twin=lambda k=kind, p=p: on_cpu[k](n_shards,
                                                                  p))
                     for p in (False, True))
        obs = _Threaded(make[kind](n_shards, True, True), kind, obs=True)
        tele = {**meta, "telemetry": True}
        specs += [
            _wave_spec(f"{kind}.step", seq, "step", ops, n, None, step_b,
                       meta),
            _wave_spec(f"{kind}.run_waves[seq]", seq, "run_waves", ops, n,
                       K, seq_b, meta),
            _wave_spec(f"{kind}.run_waves[pipe]", pipe, "run_waves", ops, n,
                       K, pipe_b, meta),
            _wave_spec(f"{kind}.step[obs]", obs, "step", ops, n, None,
                       step_b, tele),
            _wave_spec(f"{kind}.run_waves[pipe,obs]", obs, "run_waves", ops,
                       n, K, pipe_b, tele)]
        for w in bucket_ladder(L)[:-1]:
            cm = {**meta, "compact": True}
            specs += [
                _wave_spec(f"{kind}.step[compact:w{w}]", seq, "step", ops,
                           n_shards * w, None, step_b, cm, replay=True),
                _wave_spec(f"{kind}.run_waves[pipe,compact:w{w}]", pipe,
                           "run_waves", ops, n_shards * w, K, pipe_b, cm,
                           replay=True)]
    qops = _Ops("queue", W, n_prios, device, seed=len(KINDS))
    legacy = _Threaded(DeviceQueue(
        n_shards, cap=caps["queue"], payload_width=W, ops_per_shard=L,
        fused=False, device=device), "queue")
    specs.append(_wave_spec("queue-legacy.step", legacy, "step", qops, n,
                            None, wave_budget(legacy=True),
                            {"discipline": "queue", "legacy": True}))
    # the runtime twins: the same entry points built on a SimRuntime
    twin = {"discipline": "queue", "runtime": "sim"}
    for name, pipelined, K_, b in (
            ("queue.step[runtime]", False, None, step_b),
            ("queue.run_waves[pipe,runtime]", True, K, pipe_b)):
        rt = SimRuntime(n_shards, device=device)
        t = _Threaded(make["queue"](n_shards, pipelined, runtime=rt,
                                    device=None), "queue")
        specs.append(_wave_spec(name, t, "run_waves" if K_ else "step",
                                qops, n, K_, b, twin))
    return specs


def build_migration_programs(n_shards: int = 8, L: int = 2, W: int = 2,
                             device="cuda", *, n_prios: int = 3,
                             n_buckets: int = 4, slot_depth: int = 4,
                             caps: Dict[str, int] = CAPS
                             ) -> List[ProgramSpec]:
    """The elastic migration of all four disciplines as a shrink
    ``n_shards -> n_shards - 2`` (the reference's ``P0 -> P0 - 2``), after
    one wave of enqueues (at most half the smaller set's slots) so that it
    moves live elements."""
    from ..dqueue import (ElasticDevicePriorityQueue, ElasticDeviceQueue,
                          ElasticDeviceSeapQueue, ElasticDeviceStack)
    if n_shards < 3:
        return []
    kw = dict(payload_width=W, ops_per_shard=L, device=device)
    make = {
        "queue": lambda: ElasticDeviceQueue(n_shards, cap=caps["queue"],
                                            **kw),
        "stack": lambda: ElasticDeviceStack(n_shards, cap=caps["stack"],
                                            slot_depth=slot_depth, **kw),
        "priority": lambda: ElasticDevicePriorityQueue(
            n_shards, n_prios=n_prios, cap=caps["priority"], **kw),
        "seap": lambda: ElasticDeviceSeapQueue(
            n_shards, n_buckets=n_buckets, cap=caps["seap"], **kw),
    }
    specs: List[ProgramSpec] = []
    for i, kind in enumerate(KINDS):
        eq = make[kind]()
        ops = _Ops(kind, W, n_prios, device, seed=100 + i)
        fill = ops(n_shards * L)
        live = min(n_shards * L, (n_shards - 2) * caps[kind] // 2)
        valid = torch.arange(n_shards * L, device=fill[1].device) < live
        eq.step(torch.ones_like(fill[0]), valid, *fill[2:])

        def stores(eq=eq, kind=kind):
            return {f: getattr(eq.state, f) for f in STORE_FIELDS[kind]}

        specs.append(ProgramSpec(
            f"{kind}.migration", eq.runtime, MIGRATION_BUDGET,
            prepare=lambda: (), run=lambda args, eq=eq: eq.resize(
                n_shards - 2),
            stores=stores, held=0, donated_leaves=2,
            left_out="the two old store tensors are released, not held",
            release=True,
            meta={"discipline": kind, "P_from": n_shards,
                  "P_to": n_shards - 2}))
    return specs
