"""The SKUEUE aggregation tree as a min-plus prefix scan (FIFO part).

Counterpart of ``repro/core/scan_queue.py``.  A request acts on the anchor
state (f, l) = (first, last) as

    ENQ:  f' = f,                 l' = l + 1
    DEQ:  f' = min(f + 1, l + 1), l' = l

and every composition stays in the family T(A, B, C): f' = min(f + A,
l + B), l' = l + C, with identity (0, INF, 0) and the composition
T1 ; T2 = (A1 + A2, min(B1 + A2, C1 + B2, INF), C1 + C2).  The composition
is associative but not commutative: every combine takes (earlier, later).
Given the exclusive prefix state (f_i, l_i) of request i, an ENQ gets
position l_i + 1 and a DEQ gets f_i if f_i <= l_i, else ⊥ = -1.

:func:`queue_scan` is the plain version of the segscan kernel
(``repro_torch.kernels.segscan``).  On one device the reference's
``sharded_queue_scan`` (per-shard scan, then a hypercube scan of the shard
carries) is this flat scan over the shard-major wave array, which holds the
reference's global order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INF = 2 ** 30   # +infinity of the tropical semiring; A, C >= 0 keep sums
#                 below 2^31 for any wave shorter than 2^30 ops
BOTTOM = -1


class QueueState(NamedTuple):
    """Anchor state: occupied positions are [first, last] (0-d int32)."""
    first: torch.Tensor
    last: torch.Tensor

    @staticmethod
    def empty(device=None) -> "QueueState":
        """The empty queue, (first, last) = (0, -1)."""
        return QueueState(torch.tensor(0, dtype=torch.int32, device=device),
                          torch.tensor(-1, dtype=torch.int32, device=device))

    @property
    def size(self) -> torch.Tensor:
        """Live element count, ``last - first + 1``."""
        return self.last - self.first + 1


def queue_op_transforms(is_enq: torch.Tensor):
    """Per-request (A, B, C) int32 transforms; is_enq: bool or int."""
    e = is_enq.to(torch.int32)
    A = 1 - e                                    # ENQ: 0, DEQ: 1
    B = torch.where(e > 0, INF, 1).to(torch.int32)   # ENQ: INF, DEQ: 1
    C = e                                        # ENQ: 1, DEQ: 0
    return A, B, C


def queue_compose(t1, t2):
    """(t1 then t2), elementwise.  Not commutative: t1 is the earlier."""
    A1, B1, C1 = t1
    A2, B2, C2 = t2
    return (A1 + A2,
            torch.clamp_max(torch.minimum(B1 + A2, C1 + B2), INF),
            C1 + C2)


def _inclusive_scan(tr):
    """Hillis-Steele inclusive scan of (A, B, C) along the last dim:
    log2(n) rounds, each composing element i - shift (earlier) with i."""
    A, B, C = tr
    n = A.shape[-1]
    shift = 1
    while shift < n:
        nA, nB, nC = queue_compose(
            (A[..., :-shift], B[..., :-shift], C[..., :-shift]),
            (A[..., shift:], B[..., shift:], C[..., shift:]))
        A = torch.cat([A[..., :shift], nA], -1)
        B = torch.cat([B[..., :shift], nB], -1)
        C = torch.cat([C[..., :shift], nC], -1)
        shift *= 2
    return A, B, C


def _exclusive(inc, fills=(0, INF, 0)):
    """Inclusive results -> exclusive (shift right, identity first)."""
    return tuple(torch.cat([torch.full_like(x[..., :1], f), x[..., :-1]], -1)
                 for x, f in zip(inc, fills))


def queue_scan(is_enq: torch.Tensor, state: QueueState,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, QueueState]:
    """Assign positions to a flat request batch (global order = array order).

    Args:
      is_enq: [n] bool, True for ENQUEUE.
      state: the incoming anchor state (0-d int32 tensors).
      valid: [n] bool padding mask; False entries are identity transforms.
    Returns:
      positions [n] int32 (⊥ = -1), matched [n] bool, the new state.
    """
    if valid is not None:
        A, B, C = queue_op_transforms(is_enq & valid)
        tr = (torch.where(valid, A, 0), torch.where(valid, B, INF),
              torch.where(valid, C, 0))
        tr = tuple(x.to(torch.int32) for x in tr)
    else:
        tr = queue_op_transforms(is_enq)
    if is_enq.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=is_enq.device),
                torch.empty(0, dtype=torch.bool, device=is_enq.device), state)
    inc = _inclusive_scan(tr)
    Ax, Bx, Cx = _exclusive(inc)
    f_i = torch.minimum(state.first + Ax, state.last + Bx)
    l_i = state.last + Cx
    pos = torch.where(is_enq, l_i + 1,
                      torch.where(f_i <= l_i, f_i, BOTTOM)).to(torch.int32)
    matched = pos != BOTTOM
    if valid is not None:
        pos = torch.where(valid, pos, BOTTOM).to(torch.int32)
        matched = matched & valid
    A_t, B_t, C_t = (x[-1] for x in inc)
    new = QueueState(torch.minimum(state.first + A_t, state.last + B_t),
                     state.last + C_t)
    return pos, matched, new
