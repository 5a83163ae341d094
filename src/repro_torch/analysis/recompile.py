"""Rule family 3: rebuild guard.

Counterpart of ``repro/analysis/recompile.py``.  The reference counts
XLA backend compiles (``jax.monitoring``) while an elastic queue bounces
between shard counts, burst lengths and ladder widths, and requires the
second identical bounce to compile nothing.  Eager torch compiles no
program; what it builds, caches and may rebuild by mistake is:

* the CUDA libraries: ``kernels/backend.py:build`` compiles a
  ``csrc/*.cu`` it does not find built (``build.compiled``);
* the inner fixed-size structure per shard set
  (``Elastic*._inner_cache``, ``dqueue/elastic.py``): a new entry builds
  a structure (its discipline, engine and telemetry ring);
* the segscan look-back status buffer (``_STATUS``,
  ``kernels/segscan/kernel.py``): one per (device, stream), regrown
  when a wave needs more tiles;
* on CUDA, device memory: growth of ``torch.cuda.memory_reserved()``
  (the caching allocator reserves more when a shape it has not served
  comes).

:class:`RebuildTracker` counts all four over a ``with`` block.
:func:`check_recompile_guard` runs the reference's bounce twice: the
first pass may rebuild; the second, identical pass must rebuild
nothing; a first pass that counts nothing is a violation too, since the
guard would then be vacuous (the CPU included, where nvcc never runs:
the grown shard set's inner structure is new on the first pass).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .report import Violation


def _status_buffers() -> dict:
    from ..kernels.segscan import kernel as sk
    return {k: v[0] for k, v in sk._STATUS.items()}


class RebuildTracker:
    """Counts what eager torch rebuilds inside a ``with`` block, over the
    elastic ``structures`` it watches (their ``_inner_cache``).

    After the block: ``compiled`` (libraries compiled), ``inner`` (new
    inner structures), ``status`` (status buffers allocated or regrown),
    ``reserved_growth`` (bytes, CUDA only) and ``count``, their sum with
    a growth of reserved memory counting one."""

    def __init__(self, *structures, device=None):
        self.structures = structures
        self.device = torch.device(device) if device is not None else None
        self.compiled = self.inner = self.status = 0
        self.reserved_growth = 0
        self.count = 0

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def __enter__(self) -> "RebuildTracker":
        from ..kernels.backend import build
        self._built = build.compiled
        # strong references to the entries held: an id is never reused
        self._caches = [dict(s._inner_cache) for s in self.structures]
        self._status = _status_buffers()
        if self._cuda():
            torch.cuda.synchronize(self.device)
            self._reserved = torch.cuda.memory_reserved(self.device)
        return self

    def __exit__(self, *exc: Any) -> None:
        from ..kernels.backend import build
        self.compiled = build.compiled - self._built
        self.inner = sum(
            sum(1 for k, v in s._inner_cache.items() if before.get(k) is not v)
            for s, before in zip(self.structures, self._caches))
        now = _status_buffers()
        self.status = sum(1 for k, b in now.items()
                          if self._status.get(k) is not b)
        if self._cuda():
            torch.cuda.synchronize(self.device)
            self.reserved_growth = max(
                0, torch.cuda.memory_reserved(self.device) - self._reserved)
        self.count = (self.compiled + self.inner + self.status
                      + int(self.reserved_growth > 0))
        del self._caches, self._status

    def as_dict(self) -> Dict[str, int]:
        return {"count": self.count, "compiled": self.compiled,
                "inner": self.inner, "status": self.status,
                "reserved_growth": self.reserved_growth}


def _bounce(eq, K_a: int, K_b: int, grow_by: int) -> None:
    """One full membership + burst-length + ladder-width bounce on an
    elastic queue: step, burst K_a, burst K_b, K_a again, the ladder up
    and down, grow, step, burst K_a, the ladder on the grown membership,
    shrink back, step (``repro/analysis/recompile.py:62-103``)."""
    P0 = eq.n_shards
    dev = eq.device

    def drive_step(w=None):
        n = eq.n_shards * (eq.L if w is None else w)
        eq.step(torch.zeros(n, dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
                torch.zeros((n, eq.W), dtype=torch.int32, device=dev))

    def drive_waves(K: int):
        n = eq.n_shards * eq.L
        eq.run_waves(torch.zeros((K, n), dtype=torch.bool, device=dev),
                     torch.zeros((K, n), dtype=torch.bool, device=dev),
                     torch.zeros((K, n, eq.W), dtype=torch.int32,
                                 device=dev))

    def drive_ladder():
        for w in eq.bucket_widths():            # narrow -> full width
            drive_step(w)
        for w in reversed(eq.bucket_widths()):  # and back down
            drive_step(w)

    drive_step()
    drive_waves(K_a)
    drive_waves(K_b)
    drive_waves(K_a)                      # K bounce back
    drive_ladder()                        # width bounce
    eq.grow(grow_by)
    drive_step()
    drive_waves(K_a)
    drive_ladder()                        # the ladder on the grown set
    eq.shrink(list(range(P0, P0 + grow_by)))
    drive_step()


def bounce_sizes(n_shards: int) -> dict:
    """The reference's bounce at ``n_shards`` devices: grow by 1 below 6
    shards, else 2, from ``min(4, n_shards - grow_by)`` shards of 16 slots,
    2-word payloads, width 2, bursts of 2 and 3."""
    grow_by = 1 if n_shards < 6 else 2
    P0 = min(4, n_shards - grow_by)
    return {"n_shards": P0, "pool": P0 + grow_by, "grow_by": grow_by,
            "cap": 16, "W": 2, "L": 2, "K_a": 2, "K_b": 3}


def check_recompile_guard(device="cuda", sizes: Optional[dict] = None,
                          make=None) -> Tuple[List[Violation],
                                              Dict[str, Any]]:
    """Warm one bounce (rebuilds allowed), then repeat it and require the
    tracker to count nothing.  ``sizes``: :func:`bounce_sizes`'s keys
    (default its 8-shard bounce); ``make``: the elastic queue class
    (default ``ElasticDeviceQueue``)."""
    from ..dqueue import ElasticDeviceQueue
    sz = dict(sizes or bounce_sizes(8))
    if sz["n_shards"] < 2:
        return [], {"skipped": f"needs >= 2 shards, have {sz['n_shards']}"}
    make = make or ElasticDeviceQueue
    eq = make(sz["n_shards"], cap=sz["cap"], payload_width=sz["W"],
              ops_per_shard=sz["L"], pool_size=sz["pool"], device=device)
    with RebuildTracker(eq, device=eq.device) as warm:
        _bounce(eq, sz["K_a"], sz["K_b"], sz["grow_by"])
    with RebuildTracker(eq, device=eq.device) as second:
        _bounce(eq, sz["K_a"], sz["K_b"], sz["grow_by"])

    info: Dict[str, Any] = {
        "warm_rebuilds": warm.count, "second_bounce_rebuilds": second.count,
        "warm": warm.as_dict(), "second": second.as_dict(), **sz}
    out: List[Violation] = []
    if warm.count == 0:
        out.append(Violation(
            "recompile_guard", "elastic.bounce",
            "tracker observed no rebuild on the cold bounce — the tracker "
            "is broken, the guard is vacuous", dict(info)))
    if second.count != 0:
        out.append(Violation(
            "recompile_guard", "elastic.bounce",
            f"{second.count} rebuild(s) on an identical second "
            f"membership/burst/width bounce — a cache is leaking "
            f"({second.as_dict()})", dict(info)))
    # the cache must be populated (one inner structure per shard set)
    if len(eq._inner_cache) < 2:
        out.append(Violation(
            "recompile_guard", "elastic.bounce",
            "the inner-structure cache holds fewer than the two shard sets "
            "of the bounce — cache keying bypassed",
            {"inner": len(eq._inner_cache)}))
    info["migrations"] = len(eq.migrations)
    info["moved_total"] = int(sum(np.asarray(m["moved"])
                                  for m in eq.migrations))
    return out, info
