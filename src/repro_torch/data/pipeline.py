"""Deterministic data pipeline with a sequentially-consistent global order.

Counterpart of ``repro/data/pipeline.py``.  Sample content is a pure
function of the global sample index (splitmix), so any worker can
materialize any sample.  The *order* in which samples are consumed is the
SKUEUE dequeue order: a producer enqueues sample indices, DP workers
dequeue — Definition 1 guarantees the global consumption order is a
single FIFO regardless of worker count or timing.  Consequences:

  * elastic determinism: resizing the worker fleet mid-run cannot reorder
    or drop samples (the queue state is the cursor);
  * restart determinism: the queue cursor (first/last) is checkpointed with
    the model, so a restarted run replays the identical stream.

Tokens are made on ``device`` (the card by default) from the uint64 bits
held in int64 (:mod:`repro_torch.core.hashing`), bit for bit the
reference's numpy.
"""
from __future__ import annotations

import torch

from ..core.hashing import splitmix64, umod64

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)   # its uint64 bits as an int64


def synthetic_tokens(sample_idx, seq_len: int, vocab: int,
                     device="cuda") -> torch.Tensor:
    """Pure function of (sample_idx, t): a hash-driven random walk with
    small steps, so next-token prediction is learnable (p(next|cur) is
    concentrated) while remaining stateless and reproducible.  Returns
    int32 ``[len(sample_idx), seq_len]`` on ``device``."""
    idx = torch.as_tensor(sample_idx, dtype=torch.int64,
                          device=device)[:, None]
    t = torch.arange(seq_len, dtype=torch.int64, device=device)[None, :]
    h = splitmix64(idx * _GOLDEN + t)
    start = umod64(splitmix64(idx), vocab)
    steps = umod64(h, 3)                      # walk steps in {0,1,2}
    walk = start + torch.cumsum(steps, dim=1)
    return (walk % vocab).to(torch.int32)


class GlobalOrderPipeline:
    """Host-side view of the queue-ordered stream for one worker.

    The queue semantics collapse to an interval handout when the producer
    enqueues 0..N monotonically: dequeue order IS index order (that is
    exactly Definition 1's guarantee).  Batches are tensors on ``device``."""

    def __init__(self, seq_len: int, vocab: int, global_batch: int,
                 start_index: int = 0, device="cuda"):
        self.seq_len = seq_len
        self.vocab = vocab
        self.global_batch = global_batch
        self.cursor = start_index  # == queue `first`
        self.device = torch.device(device)

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])

    def _slice(self, base: int, n_workers: int, worker: int) -> dict:
        per = self.global_batch // n_workers
        lo = base + worker * per
        mine = torch.arange(lo, lo + per, dtype=torch.int64,
                            device=self.device)
        toks = synthetic_tokens(mine, self.seq_len + 1, self.vocab,
                                device=self.device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "sample_indices": mine}

    def next_batch(self, n_workers: int = 1, worker: int = 0) -> dict:
        """Global batch, sliced for this worker. Advances the cursor."""
        base = self.cursor
        self.cursor += self.global_batch
        return self._slice(base, n_workers, worker)

    def batch_at_step(self, step: int, n_workers: int = 1,
                      worker: int = 0) -> dict:
        """Pure function of step — restart/elastic determinism by construction."""
        return self._slice(step * self.global_batch, n_workers, worker)
