"""The port's FIFO segscan against the JAX reference, bit for bit.

The same numpy inputs go through ``repro.core.scan_queue.queue_scan``,
``repro.kernels.segscan.queue_scan_pallas(interpret=True)`` and the port's
``repro_torch.kernels.segscan.queue_scan`` on CPU tensors (its plain
version).  All outputs are int32 or bool: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.scan_queue import QueueState as JQueueState
from repro.core.scan_queue import StackState as JStackState
from repro.core.scan_queue import queue_compose as j_compose
from repro.core.scan_queue import queue_op_transforms as j_transforms
from repro.core.scan_queue import queue_scan as _j_queue_scan
from repro.kernels.segscan import queue_scan_pallas

from repro_torch.core.scan_queue import (INF, QueueState, StackState,
                                         queue_compose, queue_op_transforms)
from repro_torch.core.scan_queue import queue_scan as t_core_scan
from repro_torch.kernels.segscan import queue_scan, queue_scan_ref


j_queue_scan = jax.jit(_j_queue_scan)   # eager dispatch is slow on CPU


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "ragged":
        n = 1500
        return rng.random(n) < 0.6, rng.random(n) < 0.8, 0, -1
    if name == "all_invalid":
        n = 1024
        return rng.random(n) < 0.5, np.zeros(n, bool), 5, 9
    if name == "deq_on_empty":
        n = 777
        return np.zeros(n, bool), np.ones(n, bool), 0, -1
    if name == "nonzero_state":
        n = 2048 + 3
        return rng.random(n) < 0.35, rng.random(n) < 0.9, 1_000_000, 1_005_000
    if name == "tiny":
        return np.array([True]), np.array([True]), 0, -1
    raise KeyError(name)


CASES = ["ragged", "all_invalid", "deq_on_empty", "nonzero_state", "tiny"]


@pytest.mark.parametrize("case", CASES)
def test_queue_scan_matches_jax_core(case):
    e, v, f, l = _case(case)
    jp, jm, jn = j_queue_scan(jnp.asarray(e), JQueueState(jnp.int32(f),
                                                          jnp.int32(l)),
                              valid=jnp.asarray(v))
    tp, tm, tf, tl = queue_scan(torch.from_numpy(e), torch.from_numpy(v),
                                _i32(f), _i32(l))
    assert tp.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tf), int(tl)) == (int(jn.first), int(jn.last))


@pytest.mark.parametrize("case", ["ragged", "deq_on_empty", "nonzero_state"])
def test_queue_scan_matches_pallas_interpret(case):
    e, v, f, l = _case(case, seed=1)
    jp, jm, jf, jl = queue_scan_pallas(jnp.asarray(e), jnp.asarray(v),
                                       jnp.int32(f), jnp.int32(l),
                                       interpret=True)
    tp, tm, tf, tl = queue_scan(torch.from_numpy(e), torch.from_numpy(v),
                                _i32(f), _i32(l))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tf), int(tl)) == (int(jf), int(jl))


def test_queue_scan_without_valid_mask_matches_jax():
    rng = np.random.default_rng(3)
    e = rng.random(300) < 0.4
    jp, jm, jn = j_queue_scan(jnp.asarray(e), JQueueState(jnp.int32(7),
                                                          jnp.int32(20)))
    tp, tm, tn = t_core_scan(torch.from_numpy(e),
                             QueueState(_i32(7), _i32(20)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tn.first), int(tn.last)) == (int(jn.first), int(jn.last))


def test_transforms_and_compose_match_jax():
    rng = np.random.default_rng(4)
    e1, e2 = rng.random(64) < 0.5, rng.random(64) < 0.5
    jt1, jt2 = j_transforms(jnp.asarray(e1)), j_transforms(jnp.asarray(e2))
    tt1 = queue_op_transforms(torch.from_numpy(e1))
    tt2 = queue_op_transforms(torch.from_numpy(e2))
    for a, b in zip(tt1, jt1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(queue_compose(tt1, tt2), j_compose(jt1, jt2)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the compose is not commutative: (DEQ ; ENQ) != (ENQ ; DEQ)
    deq = queue_op_transforms(torch.tensor([False]))
    enq = queue_op_transforms(torch.tensor([True]))
    assert ([int(x) for x in queue_compose(deq, enq)]
            != [int(x) for x in queue_compose(enq, deq)])
    assert INF == 2 ** 30


def test_queue_scan_is_plain_on_cpu_tensors():
    e, v, f, l = _case("ragged")
    before = queue_scan.launches
    out = queue_scan(torch.from_numpy(e), torch.from_numpy(v), _i32(f),
                     _i32(l))
    ref = queue_scan_ref(torch.from_numpy(e), torch.from_numpy(v), _i32(f),
                         _i32(l))
    assert queue_scan.launches == before       # the kernel never ran
    for a, b in zip(out, ref):
        assert torch.equal(a, b)



@pytest.mark.parametrize("state,j_state", [(QueueState, JQueueState),
                                           (StackState, JStackState)])
def test_empty_state_on_cpu_and_cuda_by_default(state, j_state, monkeypatch):
    """``empty(device="cpu")`` is the reference's empty state on the CPU;
    ``empty()`` means CUDA, as every entry point of the port, and raises
    where there is none instead of building CPU tensors."""
    st = state.empty("cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.int32
               and t.dim() == 0 for t in st)
    assert [int(t) for t in st] == [int(x) for x in j_state.empty()]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        state.empty()
