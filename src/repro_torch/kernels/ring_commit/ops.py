"""Public wrapper of the Stage-4 store rewrite: kernel on CUDA, plain on
CPU.

The wave engine's FIFO, priority and Seap disciplines call it once a
commit.  The reference has no kernel here (``ring_commit`` is plain
``jnp``); the CUDA kernel replaces the plain version's scatter, fills,
gathers and ``cat`` over the dense receive buffer by one pass.
"""
from __future__ import annotations

from .ref import ring_commit_ref


def ring_commit(store, recv, junk: int, W: int):
    """Apply a wave's received PUT and GET rows to the store, in place.

    store: (store_vals [n, junk+1, W] int32, store_full [n, junk+1] bool);
    recv: ``[n, n_src, L, 2+W]`` int32 rows ``slot ‖ tag ‖ payload``, any
    strides.  Returns (store, reply ``[n, n_src, L, 1+W]`` int32 ``ok ‖
    value``, commit-time overflow: a 0-d False).  A CUDA tensor goes to
    the CUDA kernel, which raises if it cannot be built or launched; a CPU
    tensor goes to the plain version.  ``ring_commit.launches`` counts
    launches.

    Both give the same store (its junk row aside) and the same ``ok``
    column; a GET row's reply value is the slot's value whatever its full
    bit.  The kernel writes zeros in the reply of PUT and inactive rows,
    where the plain version leaves the junk row's garbage.
    """
    if recv.device.type != "cuda":
        return ring_commit_ref(store, recv, junk, W)
    from .kernel import ring_commit_kernel
    out = ring_commit_kernel(store, recv, junk, W)
    if recv.shape[0]:              # a process with no shard launches none
        ring_commit.launches += 1
    return out


ring_commit.launches = 0
