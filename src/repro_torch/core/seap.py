"""Constants and seed validation of Seap's bucket directory.

The port's own copy of what it needs from ``repro/core/seap.py``, whose
docstring states the semantics the port implements: an active bucket
serves the keys from its boundary ``lo`` up to the next active boundary,
dequeues drain buckets in ascending boundary order (FIFO inside one), and
an in-wave split/merge rule refines the directory.  The host oracle
``SeapOracle`` stays in the reference, and the port's tests use it there.
"""
from __future__ import annotations

BOTTOM = -1
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


def check_seed_bounds(seed_bounds, n_buckets: int) -> list:
    """Validate a warm-start boundary list for the bucket directory.

    Seeding plants boundaries over the expected key range up front, so
    the directory orders keys from the first wave instead of after the
    split rule has zoomed in.  Bounds must be strictly increasing, above
    ``INT32_MIN`` (the root's boundary), and fit in the non-root bucket
    ids.  Returns them as a list of ints; raises ``ValueError``.
    """
    seeds = [int(s) for s in (() if seed_bounds is None else seed_bounds)]
    if len(seeds) > n_buckets - 1:
        raise ValueError(f"{len(seeds)} seed bounds need at least "
                         f"{len(seeds) + 1} buckets, have {n_buckets}")
    if any(b <= a for a, b in zip(seeds, seeds[1:])):
        raise ValueError(f"seed bounds must be strictly increasing: {seeds}")
    if seeds and not INT32_MIN < seeds[0] <= INT32_MAX:
        raise ValueError(f"seed bounds must lie in (INT32_MIN, INT32_MAX]: "
                         f"{seeds}")
    return seeds
