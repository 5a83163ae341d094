"""SimRuntime: LocalRuntime plus a modelled wire and scheduled failures.

Counterpart of ``repro/runtime/sim.py``, with its arithmetic.  The cost
models of the wave stack are stated in collective launches and bytes
moved, so they can be priced under any latency regime: count the
launches the wave stack performed and multiply by a modelled
per-launch and per-byte cost.  SimRuntime keeps that simulated wire
clock beside the real one, and raises scheduled
:class:`~repro_torch.fault.failures.ShardFailure` s keyed by stable shard
id, so churn experiments compose with the fault layer.

Charging rules (the reference's):

* a K-wave burst charges ``K + 1`` all_to_all launches when pipelined
  and ``2 K`` sequential, each carrying the ``n_shards * width`` request
  envelope of ``4 * (2 + W)`` bytes per op row (slot ‖ tag ‖ payload);
* a migration charges 1 all_to_all of ``stats["bytes_moved"]`` plus 2
  scalar all_reduce launches of 4 bytes (the lost-element flag and the
  moved count), and annotates the stats with the charged ``sim_s``.

The charge is host arithmetic at burst boundaries; the waves still run
on the runtime's device, bit-identical to LocalRuntime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .local import LocalRuntime

_MIB = float(1 << 20)


@dataclasses.dataclass
class LatencyModel:
    """Per-collective wire cost: ``base_us`` per launch plus
    ``per_mib_us`` per MiB moved, with optional per-kind overrides
    (``per_collective={"all_reduce": {"base_us": 40.0}}``)."""

    base_us: float = 0.0
    per_mib_us: float = 0.0
    per_collective: Dict[str, dict] = dataclasses.field(
        default_factory=dict)

    def latency_s(self, kind: str, nbytes: int = 0) -> float:
        """Modelled seconds for ONE ``kind`` launch of ``nbytes``."""
        o = self.per_collective.get(kind, {})
        base = float(o.get("base_us", self.base_us))
        per_mib = float(o.get("per_mib_us", self.per_mib_us))
        return (base + per_mib * (nbytes / _MIB)) * 1e-6


class SimRuntime(LocalRuntime):
    """LocalRuntime with a simulated wire.

    Args:
      pool_size, device: as :class:`LocalRuntime`.
      latency: the :class:`LatencyModel` (default: a free wire).
      fail_at: ``{step: shard_id}``; :meth:`maybe_fail` raises a
        ``ShardFailure`` carrying that stable ``device_id`` the first time
        each step is reached (the fault layer calls it once per step).
    """

    kind = "sim"

    def __init__(self, pool_size: int, latency: Optional[LatencyModel] = None,
                 *, fail_at: Optional[Dict[int, int]] = None, device=None):
        super().__init__(pool_size, device=device)
        self.latency = latency or LatencyModel()
        self.fail_at = dict(fail_at or {})
        self._fired: set = set()
        self.sim_time_s = 0.0
        self.counts: Dict[str, int] = {}
        self.bytes_by_kind: Dict[str, int] = {}

    # ------------------------------------------------------- charging ------
    def collective_latency(self, kind: str, nbytes: int = 0) -> float:
        return self.latency.latency_s(kind, nbytes)

    def charge(self, kind: str, launches: int, nbytes_each: int = 0
               ) -> float:
        """Charge ``launches`` collectives of ``nbytes_each`` to the sim
        clock; returns the seconds added."""
        dt = launches * self.latency.latency_s(kind, nbytes_each)
        self.sim_time_s += dt
        self.counts[kind] = self.counts.get(kind, 0) + int(launches)
        self.bytes_by_kind[kind] = (self.bytes_by_kind.get(kind, 0)
                                    + int(launches) * int(nbytes_each))
        return dt

    @staticmethod
    def burst_launches(n_waves: int, pipelined: bool) -> int:
        """all_to_all launches of a K-wave burst: K+1 pipelined (request_k
        ‖ reply_{k-1} fuse), 2K sequential."""
        return n_waves + 1 if pipelined else 2 * n_waves

    @staticmethod
    def wave_envelope_bytes(n_shards: int, width: int,
                            payload_width: int) -> int:
        """Bytes one wave's request envelope puts on the wire:
        ``n_shards * width`` op rows of ``slot ‖ tag ‖ payload`` int32
        columns."""
        return n_shards * width * 4 * (2 + payload_width)

    def on_burst(self, kind: str, n_waves: int, n_shards: int, *,
                 width: int, payload_width: int,
                 pipelined: bool = True) -> None:
        self.charge("all_to_all", self.burst_launches(n_waves, pipelined),
                    self.wave_envelope_bytes(n_shards, width, payload_width))

    def on_migration(self, stats: dict) -> None:
        dt = self.charge("all_to_all", 1, int(stats.get("bytes_moved", 0)))
        dt += self.charge("all_reduce", 2, 4)
        stats["sim_s"] = dt

    # ------------------------------------------------------- failures ------
    def maybe_fail(self, step: int) -> None:
        step = int(step)
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            from ..fault.failures import ShardFailure
            raise ShardFailure(None, step, device_id=int(self.fail_at[step]))

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap.update(sim_time_s=self.sim_time_s,
                    collectives=dict(self.counts),
                    bytes_by_kind=dict(self.bytes_by_kind),
                    latency=dataclasses.asdict(self.latency))
        return snap
