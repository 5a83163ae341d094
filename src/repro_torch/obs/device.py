"""Device-side Wavescope metrics: the ring buffer each wave writes a row to.

Counterpart of ``repro/obs/device.py``.  Every field of a wave's row is
arithmetic on values the wave already holds at dispatch time (the op
masks, the routing decisions, the interval carry), so telemetry adds no
exchange.  The ring lives on the device beside the state; each write is
an ``index_copy_`` at ``count % ring`` computed on the device, and
``count`` stays a 0-d device tensor, so recording never reads the device
on the host.  :func:`drain` is the one host read, at burst boundaries.

Row layout (all int32), one row per shard::

    seq ‖ puts ‖ gets ‖ valid ‖ bottom ‖ aux ‖ headroom ‖ width ‖
    occ[n_windows]

* ``seq``      wave sequence number (replicated; monotone across bursts);
* ``puts``     PER-SHARD admitted enqueues this wave (summed at drain);
* ``gets``     PER-SHARD admitted dequeues this wave (summed at drain);
* ``valid``    PER-SHARD valid ops offered this wave (summed at drain);
* ``bottom``   PER-SHARD valid ops that were not routed (⊥) (summed);
* ``aux``      the discipline's per-wave extra: ``n_relaxed`` for the
               priority queue, ``n_active`` for Seap, 0 otherwise;
* ``headroom`` free slots across every window after the wave;
* ``width``    per-shard envelope width the wave rode;
* ``occ[w]``   post-dispatch occupancy of window ``w``.

The per-shard counters sum each shard's ``[L]`` slice of the flat
``[n·L]`` op arrays, as each shard of the reference sums its own block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

METRIC_HEAD = ("seq", "puts", "gets", "valid", "bottom", "aux", "headroom",
               "width")
N_HEAD = len(METRIC_HEAD)
_ADDITIVE = frozenset({"puts", "gets", "valid", "bottom"})


class MetricsState(NamedTuple):
    """The telemetry ring: ``count`` (0-d int32, the number of waves ever
    recorded, the next row's ``seq``) and ``rows`` (``[n_shards, ring,
    N_HEAD + n_windows]`` int32)."""
    count: torch.Tensor
    rows: torch.Tensor


def row_width(n_windows: int) -> int:
    """Columns of one row: the fixed head plus one per window."""
    return N_HEAD + int(n_windows)


def init_metrics_state(n_shards: int, ring: int, n_windows: int,
                       device) -> MetricsState:
    """A zeroed ring on ``device``."""
    return MetricsState(
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((n_shards, ring, row_width(n_windows)),
                    dtype=torch.int32, device=device))


def record_row(m: MetricsState, row: torch.Tensor) -> MetricsState:
    """Write one wave's ``[n_shards, M]`` rows at ring index ``count %
    ring``, in place, and return the state with ``count + 1``.  The index
    is computed on the device: no host read."""
    ring = m.rows.shape[1]
    idx = torch.remainder(m.count, ring).view(1).long()
    m.rows.index_copy_(1, idx, row.to(torch.int32)[:, None, :])
    return MetricsState(m.count + 1, m.rows)


def drain(m: MetricsState) -> list:
    """HOST read at a burst boundary: the ring's rows in chronological
    order, the shard dimension combined (per-shard counters summed,
    replicated fields read off shard 0).  Returns wave-summary dicts,
    oldest first; ``occ`` is the per-window occupancy list."""
    count = int(m.count)
    rows = m.rows.cpu().numpy()            # [n_shards, ring, M]
    ring = rows.shape[1]
    n_valid = min(count, ring)
    if n_valid == 0:
        return []
    order = [(count - k) % ring for k in range(n_valid, 0, -1)]
    summed = rows.sum(axis=0, dtype=np.int64)
    rep = rows[0]
    out = []
    for i in order:
        d = {name: int((summed if name in _ADDITIVE else rep)[i, j])
             for j, name in enumerate(METRIC_HEAD)}
        d["occ"] = [int(v) for v in rep[i, N_HEAD:]]
        out.append(d)
    return out
