"""The element an op carries, as a function of the op's id.

Every op of a run has a distinct id (its index in the run's op stream).
An enqueue carries ``words(id)``: ``W`` int32 words, each an affine mix
of the id modulo 2^32 with an odd multiplier, so distinct ids below 2^32
give distinct words in every column.  A dequeued element is checked
whole by recomputing the words of the id the model says it holds.  The
generator makes the payloads from the same constants.
"""
from __future__ import annotations

import torch

# odd multipliers below 2^31 (a product with an id below 2^32 stays below
# 2^63) and offsets, cycled when W is larger than the table
MULTIPLIERS = (1, 0x27D4EB2F, 0x165667B1, 0x61C88647, 0x2545F491,
               0x3C6EF373, 0x1B873593, 0x5BD1E995)
OFFSETS = (0, 0x7F4A7C15, 0x2F6B2D99, 0x1F123BB5, 0x6A09E667,
           0x3C6EF372, 0x510E527F, 0x1F83D9AB)
ID_LIMIT = 1 << 32


def constants(width: int) -> tuple:
    """(multipliers, offsets) of the ``width`` payload columns."""
    m = [MULTIPLIERS[j % len(MULTIPLIERS)] for j in range(width)]
    a = [OFFSETS[j % len(OFFSETS)] for j in range(width)]
    return m, a


def words(ids: torch.Tensor, width: int) -> torch.Tensor:
    """``[*ids.shape, width]`` int32 payload words of ``ids`` (int64, each
    in ``[0, 2^32)``), on ``ids``' device."""
    m, a = constants(width)
    mul = torch.tensor(m, dtype=torch.int64, device=ids.device)
    add = torch.tensor(a, dtype=torch.int64, device=ids.device)
    u = torch.remainder(ids.long()[..., None] * mul + add, 1 << 32)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
