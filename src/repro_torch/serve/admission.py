"""Admission control for the serving fabric: act BEFORE the wave loses data.

Copy of ``repro/serve/admission.py``, which imports no JAX.  A
:class:`~repro_torch.dqueue.QueueOverflowError` means data loss: by the
time the wave's flag reaches the host, a wrapped-around enqueue has
already overwritten a live head slot.  The policies here are consulted by
:meth:`repro_torch.serve.ServeEngine.submit` against the live occupancy
vector *before* staging, so a full window rejects with a structured,
retryable :class:`AdmissionRejected` at the submit edge instead of
corrupting the queue mid-wave.

The decision inputs ride :class:`PressureSignal` — a host-side snapshot
built from the elastic wrappers' pre-wave pressure API
(``occupancy()`` / ``headroom()``: one small copy of the windows'
``first``/``last`` to the host between bursts) plus the engine's own
staged and spill bookkeeping, so admission adds no exchange and no wave
to the pipeline.

Three policies ship:

``shed`` (:class:`ShedPolicy`)
    Reject what does not fit.  Within a contended window the *least
    urgent* requests are shed first — lowest tier (highest ``prio``
    number), then latest deadline, then latest arrival; on EDF engines
    requests whose deadline is already unmeetable (past, after shifting
    by the observed lateness p99) are shed before any request that can
    still make it.
``defer`` (:class:`DeferPolicy`)
    Hold what does not fit in a bounded host-side spill buffer; the
    engine re-offers spilled requests to the queue on every subsequent
    step as headroom frees up (oldest first, ahead of newer arrivals).
    A full spill buffer rejects the excess with a structured
    ``kind="spill-overflow"`` error — never a silent drop.
``degrade`` (:class:`DegradePolicy`)
    Trade SLA for admission: downgrade the request's tier (or extend its
    deadline into a less-loaded Seap bucket) until it fits, falling back
    to shed/defer when every alternative window is also full.

All three guarantee the invariant that matters: **no admitted request is
ever lost to overflow** — ``QueueOverflowError`` with a policy installed
is a bug, not an operational event.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence


@dataclasses.dataclass
class PressureSignal:
    """Host-side pressure snapshot an admission decision runs against.

    Built by the engine from the queue's pre-wave pressure API plus host
    bookkeeping; mutated in place (via :meth:`take`) as a decision
    reserves slots, so one signal stays consistent across a whole batch.

    Attributes:
      capacity: elements ONE window holds (per tier/bucket).
      occupancy: committed device occupancy per window (post last burst).
      staged: host-staged (submitted, not yet flushed) count per window.
      spill: current defer-buffer depth (requests already accepted but
        held host-side).
      spill_cap: defer-buffer bound.
      step: current engine step (EDF "now").
      mode: admission discipline — "fifo", "tiers", or "edf".
      lateness_p99: recent EDF lateness p99 in steps (0.0 when unknown);
        shifts the horizon behind which a deadline counts as doomed.
      drain_per_step: rough service-rate hint (engine slots) used for
        the retry-after estimate.
      window_of: maps a request to its window index (tier, Seap bucket,
        or 0 for FIFO).
      window_order: active window ids in *key* order (EDF bucket ids are
        not sorted by deadline range; tiers/FIFO leave this None for
        natural order) — the degrade policy walks "later" windows along
        this order.
      window_lo: window id → lowest key the window covers (EDF only);
        the deadline a degraded request is extended to.
    """

    capacity: int
    occupancy: List[int]
    staged: List[int]
    spill: int
    spill_cap: int
    step: int
    mode: str
    lateness_p99: float
    drain_per_step: int
    window_of: Callable
    window_order: Optional[List[int]] = None
    window_lo: Optional[dict] = None

    @property
    def n_windows(self) -> int:
        """Number of store windows (tiers / buckets; 1 for FIFO)."""
        return len(self.occupancy)

    def predicted(self, w: int) -> int:
        """Window ``w``'s occupancy once everything staged flushes."""
        return self.occupancy[w] + self.staged[w]

    def headroom(self, w: int) -> int:
        """Slots left in window ``w`` before an enqueue would wrap."""
        return self.capacity - self.predicted(w)

    def take(self, w: int) -> None:
        """Reserve one slot in window ``w`` (an admit/degrade decision)."""
        self.staged[w] += 1

    def deadline_for_window(self, req, w: int) -> int:
        """The extended (never shortened) deadline that lands ``req`` in
        EDF bucket ``w`` — the bucket's lowest covered key."""
        lo = (self.window_lo or {}).get(w, 0)
        return max(getattr(req, "deadline", 0), int(lo))

    def doomed(self, req) -> bool:
        """True when ``req``'s deadline is already unmeetable: it falls
        behind "now" shifted by the observed admission lateness p99."""
        if self.mode != "edf" or getattr(req, "deadline", -1) < 0:
            return False
        return req.deadline <= self.step + max(0.0, self.lateness_p99)

    def snapshot(self) -> dict:
        """Plain-dict copy for error payloads and metrics."""
        return {"capacity": self.capacity,
                "occupancy": list(self.occupancy),
                "staged": list(self.staged),
                "headroom": [self.headroom(w)
                             for w in range(self.n_windows)],
                "spill": self.spill, "spill_cap": self.spill_cap,
                "step": self.step, "mode": self.mode,
                "lateness_p99": self.lateness_p99}


class AdmissionRejected(RuntimeError):
    """A submit batch did not fully fit — and was refused *safely*.

    Raised by :meth:`repro_torch.serve.ServeEngine.submit` after the fitting
    part of the batch has been staged/deferred: everything in
    :attr:`shed` was NOT registered with the engine and NOT staged, so
    the queue is untouched by it and the error is retryable —
    resubmit ``err.shed`` (optionally after ``err.retry_after`` steps)
    and nothing is double-admitted.

    Attributes:
      policy: name of the deciding policy ("shed" / "defer" / "degrade").
      kind: "shed" (policy rejected) or "spill-overflow" (defer buffer
        was full — the bounded buffer refused, it did not silently drop).
      shed: the rejected Request objects, in arrival order.
      admitted: how many of the batch WERE staged for the queue.
      deferred: how many went to the spill buffer instead.
      degraded: how many were admitted at a downgraded tier / extended
        deadline.
      pressure: :meth:`PressureSignal.snapshot` at decision time.
      retry_after: suggested steps to wait before resubmitting (excess
        over capacity divided by the engine's drain rate; >= 1).
    """

    def __init__(self, policy: str, kind: str, shed: Sequence, *,
                 admitted: int, deferred: int, degraded: int,
                 pressure: dict, retry_after: int = 1):
        self.policy = policy
        self.kind = kind
        self.shed = list(shed)
        self.admitted = int(admitted)
        self.deferred = int(deferred)
        self.degraded = int(degraded)
        self.pressure = dict(pressure)
        self.retry_after = max(1, int(retry_after))
        super().__init__(
            f"admission policy '{policy}' rejected {len(self.shed)} "
            f"request(s) [{kind}]: admitted={admitted} "
            f"deferred={deferred} degraded={degraded} against headroom "
            f"{pressure.get('headroom')} (capacity "
            f"{pressure.get('capacity')}); rejected requests were never "
            f"staged — resubmit after ~{self.retry_after} step(s)")


@dataclasses.dataclass
class AdmissionDecision:
    """What a policy decided for one submit batch (arrival order kept).

    ``spill_overflow`` counts sheds that happened only because the defer
    buffer was full — they surface as ``kind="spill-overflow"``.
    """

    admit: list
    shed: list
    defer: list
    degraded: int = 0
    spill_overflow: int = 0


def _urgency(req, sig: PressureSignal) -> tuple:
    """Sort key: most urgent first.  Lower tier number wins, then (EDF)
    meetable-before-doomed, then earlier deadline."""
    dl = getattr(req, "deadline", -1)
    return (getattr(req, "prio", 0), sig.doomed(req),
            dl if dl >= 0 else 0)


class AdmissionPolicy:
    """Base class: split a submit batch into admit / shed / defer.

    Subclasses override :meth:`overflow` to say what happens to the
    requests that do not fit their window; the shared :meth:`decide`
    walks the batch per window, keeps arrival order for everything that
    fits, and hands the *least urgent* overflow to :meth:`overflow`
    (lowest tier first, then latest deadline, then latest arrival — and
    on EDF engines, already-doomed deadlines are first in line).
    """

    name = "admit-all"

    def decide(self, reqs: Sequence, sig: PressureSignal) -> AdmissionDecision:
        """Decide the batch against ``sig`` (mutates its staged counts).

        Args:
          reqs: Request objects in arrival order.
          sig: live :class:`PressureSignal` for the engine's queue.

        Returns:
          An :class:`AdmissionDecision`; ``admit`` preserves the arrival
          order of the admitted subset.
        """
        order = {id(r): i for i, r in enumerate(reqs)}
        by_window: dict = {}
        for r in reqs:
            by_window.setdefault(sig.window_of(r), []).append(r)
        dec = AdmissionDecision([], [], [])
        for w, group in by_window.items():
            # most urgent first; stable, so arrival order breaks ties
            ranked = sorted(group, key=lambda r: _urgency(r, sig))
            room = max(0, sig.headroom(w))
            for r in ranked[:room]:
                sig.take(w)
                dec.admit.append(r)
            if len(ranked) > room:
                self.overflow(ranked[room:], w, sig, dec)
        dec.admit.sort(key=lambda r: order[id(r)])
        dec.shed.sort(key=lambda r: order[id(r)])
        dec.defer.sort(key=lambda r: order[id(r)])
        return dec

    def overflow(self, rest: list, w: int, sig: PressureSignal,
                 dec: AdmissionDecision) -> None:
        """Handle ``rest`` (least-urgent first would be ``reversed``):
        requests window ``w`` has no headroom for.  Base admits them
        anyway (admit-all: no admission control, will overflow)."""
        for r in rest:
            sig.take(w)
            dec.admit.append(r)


class ShedPolicy(AdmissionPolicy):
    """Reject what does not fit; never buffer, never lose queue data.

    Guarantees zero ``QueueOverflowError`` and bounded memory; the cost
    is that rejected work is the caller's to retry (the
    :class:`AdmissionRejected` it triggers carries the victims and a
    retry hint).  Victim order per contended window: lowest tier /
    doomed-deadline / latest deadline / latest arrival first.
    """

    name = "shed"

    def overflow(self, rest, w, sig, dec):
        """Shed every request the window has no headroom for."""
        dec.shed.extend(rest)


class DeferPolicy(AdmissionPolicy):
    """Hold what does not fit in the engine's bounded spill buffer.

    Deferred requests are accepted (registered, counted as pending) but
    wait host-side; the engine re-offers them ahead of newer arrivals on
    every subsequent step as headroom frees.  When the spill buffer
    itself is full the excess is rejected with
    ``AdmissionRejected(kind="spill-overflow")`` — bounded means
    *refuse*, not *drop*.
    """

    name = "defer"

    def overflow(self, rest, w, sig, dec):
        """Defer into spill space; excess past ``spill_cap`` is shed."""
        room = max(0, sig.spill_cap - sig.spill - len(dec.defer))
        # most urgent of the overflow get the spill space
        dec.defer.extend(rest[:room])
        dec.shed.extend(rest[room:])
        dec.spill_overflow += len(rest[room:])


class DegradePolicy(AdmissionPolicy):
    """Admit at a worse SLA instead of rejecting.

    On a tiered engine an overflowing request is retried one tier down
    (``prio + 1`` … lowest) until a window with headroom takes it; on an
    EDF engine its deadline is extended to the next Seap bucket with
    headroom.  When every alternative is full too, falls back to
    ``fallback`` ("shed" or "defer").  FIFO engines have a single
    window, so degrade always falls back there.

    Args:
      fallback: "shed" (default) or "defer" — what to do when no window
        can take the request even degraded.
    """

    name = "degrade"

    def __init__(self, fallback: str = "shed"):
        if fallback not in ("shed", "defer"):
            raise ValueError(f"fallback must be 'shed' or 'defer', "
                             f"got {fallback!r}")
        self._fb = ShedPolicy() if fallback == "shed" else DeferPolicy()

    def overflow(self, rest, w, sig, dec):
        """Retarget each overflow request to a less-loaded window."""
        for r in rest:
            w2 = self._retarget(r, w, sig)
            if w2 is None:
                self._fb.overflow([r], w, sig, dec)
            else:
                sig.take(w2)
                dec.degraded += 1
                dec.admit.append(r)

    def _retarget(self, r, w: int, sig: PressureSignal) -> Optional[int]:
        """First window after ``w`` (in key order) with headroom, mutating
        the request's tier/deadline to land there; None when full."""
        order = sig.window_order or list(range(sig.n_windows))
        try:
            at = order.index(w)
        except ValueError:
            return None
        for w2 in order[at + 1:]:
            if sig.headroom(w2) > 0:
                if sig.mode == "tiers":
                    r.prio = w2
                elif sig.mode == "edf":
                    r.deadline = sig.deadline_for_window(r, w2)
                return w2
        return None


_POLICIES = {"shed": ShedPolicy, "defer": DeferPolicy,
             "degrade": DegradePolicy}


def resolve_policy(spec) -> Optional[AdmissionPolicy]:
    """Normalize an ``admission=`` engine argument into a policy.

    Args:
      spec: None (admission off), a policy name ("shed" / "defer" /
        "degrade"), or an :class:`AdmissionPolicy` instance.

    Returns:
      The policy instance, or None.

    Raises:
      ValueError: unknown policy name.
    """
    if spec is None or isinstance(spec, AdmissionPolicy):
        return spec
    if isinstance(spec, str):
        if spec not in _POLICIES:
            raise ValueError(f"unknown admission policy {spec!r}; "
                             f"known: {sorted(_POLICIES)}")
        return _POLICIES[spec]()
    raise ValueError(f"admission= takes None, a name, or an "
                     f"AdmissionPolicy, got {type(spec).__name__}")
