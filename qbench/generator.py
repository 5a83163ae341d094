"""The one traffic generator: bursts of ops made on the device from the
seed, as a mix's data file (``qbench/traffic/<mix>.json``) and a
configuration describe them.

A mix's parameters:

* ``waves_per_burst``: the waves ``K`` of a burst;
* ``enq_share``: the chance that an op is an enqueue, drawn for each op;
  a list gives one share to each wave of a burst in turn (``[1, 0]``:
  enqueue-only waves and dequeue-only waves by turns);
* ``valid_per_shard`` (optional): ops a shard a wave, the first of each
  shard's row; the wave's width is then the narrowest of the structure's
  ladder that holds them (``pick_width``).  Without it every op of the
  configuration's full width is valid;
* ``judge_share``, ``profile_bursts`` and ``resize``: read by the harness.

Every op of a run gets the next id of the run's op stream, whether it is
an enqueue or a dequeue, so the ids of a burst are ``id0 + arange(K*n)``
in its flat ``[K, n]`` order.  An enqueue carries ``words(id)``
(``reference/payload.py``).  Draws come from one ``torch.Generator`` on
the device, seeded by ``--seed``, in the order the run asks for bursts,
so one seed gives one op stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from .reference.payload import ID_LIMIT, words


@dataclass
class Burst:
    """One burst as the program receives it, with what the harness and
    the reference need to judge it.  The inputs are dropped once the
    burst has run and made again from the seed for the judgement; the
    fingerprint checks that they were made alike."""
    phase: str                    # "fill", "warm" or "window"
    spec: dict                    # OpStream.burst's arguments
    n_shards: int
    width: int                    # ops a shard a wave
    K: int
    n: int                        # ops a wave (n_shards * width)
    id0: int
    is_enq: Optional[torch.Tensor]     # [K, n] bool
    valid: Optional[torch.Tensor]      # [K, n] bool
    extra: dict = field(default_factory=dict)   # e.g. {"prio": [K, n]}
    payload: Optional[torch.Tensor] = None       # [K, n, W]
    n_ops: int = 0                # valid ops
    ids: Optional[torch.Tensor] = None           # [K, n] int64
    fingerprint: Optional[torch.Tensor] = None
    t_due: float = 0.0            # host clock: submission
    t_done: float = 0.0           # host clock: outputs complete
    waves: Optional[dict] = None     # per-wave outputs, kept for all
    outputs: Optional[dict] = None   # all outputs, for the judged bursts
    judged: bool = False


def fingerprint(b: Burst) -> torch.Tensor:
    """Sums of a burst's drawn inputs (a small tensor on the device)."""
    return torch.stack([b.is_enq.sum(), b.valid.sum()]
                       + [x.long().sum() for x in b.extra.values()])


def drop_inputs(b: Burst) -> None:
    """Keep a burst's fingerprint and let its inputs go."""
    b.fingerprint = fingerprint(b)
    b.is_enq = b.valid = b.payload = b.ids = None
    b.extra = {}


def regenerate(b: Burst, stream: "OpStream") -> Burst:
    """``b`` made again by a stream that has made every burst before it;
    raises where the inputs differ from those the program received."""
    r = stream.burst(b.phase, **b.spec)
    if r.id0 != b.id0 or not torch.equal(fingerprint(r), b.fingerprint):
        raise RuntimeError(f"burst at id {b.id0} made again from the seed "
                           f"differs from the one the program received")
    return r


def shares_of(enq_share) -> tuple:
    """A mix's ``enq_share`` as one share a wave, cycled."""
    if isinstance(enq_share, (list, tuple)):
        return tuple(float(s) for s in enq_share)
    return (float(enq_share),)


class OpStream:
    """Bursts of a cell's traffic on ``device`` from ``seed``."""

    def __init__(self, seed: int, device, payload_width: int, draw_extra,
                 cfg: dict):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.W = int(payload_width)
        self._draw_extra = draw_extra
        self._cfg = cfg
        self.next_id = 0
        self._masks = {}              # one validity mask a shape

    def uniform(self, shape) -> torch.Tensor:
        """Uniform draws in [0, 1) from the run's generator."""
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _mask(self, K: int, n_shards: int, width: int, per_shard: int,
              n_valid: Optional[int]) -> torch.Tensor:
        key = (K, n_shards, width, per_shard, n_valid)
        if key not in self._masks:
            row = torch.arange(width, device=self.device) < per_shard
            m = row.repeat(K * n_shards).view(K, n_shards * width)
            if n_valid is not None:
                m = m & (torch.arange(K * n_shards * width,
                                      device=self.device)
                         < n_valid).view(K, -1)
            self._masks[key] = m
        return self._masks[key]

    def burst(self, phase: str, n_shards: int, width: int, K: int,
              enq_share, per_shard: Optional[int] = None,
              n_valid: Optional[int] = None) -> Burst:
        """``K`` waves of ``n_shards * width`` ops.  Wave ``k``'s ops are
        enqueues with the chance ``shares_of(enq_share)[k % len]``; the
        first ``per_shard`` ops of each shard's row are valid (all of them
        by default), and of those only the ones among the first
        ``n_valid`` of the burst's flat order where ``n_valid`` is
        given."""
        n = n_shards * width
        per_shard = width if per_shard is None else min(int(per_shard),
                                                       width)
        if n_valid is not None and n_valid >= K * n:
            n_valid = None
        spec = {"n_shards": n_shards, "width": width, "K": K,
                "enq_share": enq_share, "per_shard": per_shard,
                "n_valid": n_valid}
        id0 = self.next_id
        self.next_id += K * n
        if self.next_id > ID_LIMIT:
            raise ValueError("the run's op ids passed 2^32")
        shares = shares_of(enq_share)
        if min(shares) >= 1.0:
            is_enq = torch.ones((K, n), dtype=torch.bool, device=self.device)
        elif len(shares) == 1:
            is_enq = self.uniform((K, n)) < shares[0]
        else:
            per_wave = torch.tensor([shares[k % len(shares)]
                                     for k in range(K)], device=self.device)
            is_enq = self.uniform((K, n)) < per_wave[:, None]
        valid = self._mask(K, n_shards, width, per_shard, n_valid)
        n_ops = K * n_shards * per_shard
        if n_valid is not None:
            n_ops = int(valid.sum())
        extra = self._draw_extra(self, (K, n), self._cfg)
        ids = torch.arange(id0, id0 + K * n, device=self.device).view(K, n)
        return Burst(phase, spec, n_shards, width, K, n, id0, is_enq, valid,
                     extra, words(ids, self.W), n_ops, ids)
