"""Hysteresis autoscaling for the elastic queue fabric.

Copy of ``repro/serve/controller.py``, which imports no JAX.  The
paper's JOIN/LEAVE exist so the queue "can be used in highly dynamic
environments", and each is one migration exchange.  This controller
watches the same pressure signal admission uses (occupancy + staged +
spill over window capacity) and turns *sustained* load above a high
watermark into ``resize(n + k)`` and *sustained* idleness below a low
watermark into a shrink: it never reacts to a single spike and never
flaps.

The controller is pure host arithmetic, so its hysteresis (the flap
guard) is testable without a device; :class:`~repro_torch.serve.
ServeEngine` wires it to real ``resize`` calls when constructed with
``autoscale=``.  Whoever else resizes (an operator, a fault layer)
reports it through :meth:`HysteresisController.notify_resize`, which
resets the patience counters and starts the cooldown, so the controller
neither fights that change nor counts it as its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ControllerConfig:
    """Watermarks and hysteresis knobs for :class:`HysteresisController`.

    Attributes:
      high_watermark: utilization (hottest-window pressure / capacity)
        above which a tick counts toward growing.
      low_watermark: utilization below which a tick counts toward
        shrinking.
      high_patience: consecutive above-watermark ticks required before a
        grow fires (spike rejection).
      low_patience: consecutive below-watermark ticks required before a
        shrink fires (kept higher than ``high_patience`` by default:
        growing late loses data, shrinking late only wastes devices).
      cooldown: ticks after ANY resize (including external/fault ones)
        during which the controller only observes — the flap guard that
        keeps a square-wave load from toggling grow/shrink every burst.
      grow_k: shards added per grow decision.
      shrink_k: shards removed per shrink decision.
      min_shards: never shrink below this.
      max_shards: never grow above this (the engine defaults it to the
        queue's device-pool size).
    """

    high_watermark: float = 0.75
    low_watermark: float = 0.25
    high_patience: int = 2
    low_patience: int = 8
    cooldown: int = 4
    grow_k: int = 1
    shrink_k: int = 1
    min_shards: int = 1
    max_shards: Optional[int] = None


class HysteresisController:
    """Sustained-pressure → resize decisions, with a flap guard.

    Call :meth:`observe` once per engine step with the current
    utilization; it returns a target shard count when (and only when) a
    resize should happen now.  Whoever executes the resize — the engine,
    or the fault layer doing a failure-LEAVE — reports it back via
    :meth:`notify_resize` so counters reset and the cooldown starts.

    Args:
      config: a :class:`ControllerConfig`; keyword overrides may be
        passed directly instead (``HysteresisController(cooldown=8)``).
      runtime: an optional :class:`~repro_torch.runtime.LocalRuntime`.
        When given and ``max_shards`` is unset, the ceiling defaults to the
        runtime's LIVE pool size — quarantined (failed) devices do not
        count, so the controller never decides to grow onto dead
        hardware.  The controller stays pure host arithmetic: the
        runtime is consulted once here, never on the observe path.

    Raises:
      ValueError: watermarks out of order or patience/cooldown negative.
    """

    def __init__(self, config: Optional[ControllerConfig] = None, *,
                 runtime=None, **kw):
        self.cfg = config or ControllerConfig(**kw)
        if runtime is not None and self.cfg.max_shards is None:
            self.cfg.max_shards = runtime.pool_size
        c = self.cfg
        if not 0.0 <= c.low_watermark < c.high_watermark:
            raise ValueError(
                f"need 0 <= low_watermark < high_watermark, got "
                f"{c.low_watermark} / {c.high_watermark}")
        if min(c.high_patience, c.low_patience, c.cooldown) < 0:
            raise ValueError("patience/cooldown must be >= 0")
        self._above = 0          # consecutive ticks above high watermark
        self._below = 0          # consecutive ticks below low watermark
        self._cooldown = 0       # ticks left before decisions resume
        self.stats = {"ticks": 0, "grows": 0, "shrinks": 0,
                      "suppressed_cooldown": 0, "external_resizes": 0}
        self.last_decision = "none"

    # ----------------------------------------------------------- inputs ---
    def observe(self, utilization: float, n_shards: int, *,
                overloaded: bool = False) -> Optional[int]:
        """One controller tick.

        Args:
          utilization: hottest-window pressure over window capacity
            (occupancy + staged + spilled, so shed/deferred load still
            registers as pressure even though it never hit the device).
          n_shards: the queue's current shard count.
          overloaded: force this tick to count as above-watermark — the
            engine sets it when the admission policy had to shed/defer
            this step, which is overload by definition even if the
            post-shed occupancy looks calm.

        Returns:
          A target shard count to ``resize`` to right now, or None.
          The caller MUST report the resize back via
          :meth:`notify_resize` once done.
        """
        self.stats["ticks"] += 1
        if self._cooldown > 0:
            self._cooldown -= 1
            if utilization >= self.cfg.high_watermark or overloaded:
                self.stats["suppressed_cooldown"] += 1
            return None
        if utilization >= self.cfg.high_watermark or overloaded:
            self._above += 1
            self._below = 0
        elif utilization <= self.cfg.low_watermark:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        c = self.cfg
        if self._above >= max(1, c.high_patience):
            hi = c.max_shards if c.max_shards is not None else n_shards
            target = min(hi, n_shards + c.grow_k)
            if target > n_shards:
                self.stats["grows"] += 1
                self.last_decision = f"grow->{target}"
                return target
            self._above = 0  # at the ceiling: nothing to do, stop counting
        if self._below >= max(1, c.low_patience):
            target = max(c.min_shards, n_shards - c.shrink_k)
            if target < n_shards:
                self.stats["shrinks"] += 1
                self.last_decision = f"shrink->{target}"
                return target
            self._below = 0  # at the floor
        return None

    def notify_resize(self, n_shards: int, *, external: bool = False) -> None:
        """Report a completed membership change (ours or anyone's).

        Resets both patience counters and starts the cooldown, so the
        controller re-learns the post-migration pressure before deciding
        again.  The fault layer calls this with ``external=True`` after a
        failure-LEAVE/regrow so the controller does not fight it.

        Args:
          n_shards: the shard count now in effect.
          external: the resize was NOT this controller's decision.
        """
        del n_shards  # the next observe() receives the live count anyway
        self._above = self._below = 0
        self._cooldown = self.cfg.cooldown
        if external:
            self.stats["external_resizes"] += 1
            self.last_decision = "external"

    # ------------------------------------------------------------ output ---
    def snapshot(self) -> dict:
        """Metrics-ready state: counters, watermarks, pending patience."""
        c = self.cfg
        return {"ticks": self.stats["ticks"], "grows": self.stats["grows"],
                "shrinks": self.stats["shrinks"],
                "suppressed_cooldown": self.stats["suppressed_cooldown"],
                "external_resizes": self.stats["external_resizes"],
                "last_decision": self.last_decision,
                "above_streak": self._above, "below_streak": self._below,
                "cooldown_left": self._cooldown,
                "high_watermark": c.high_watermark,
                "low_watermark": c.low_watermark}
