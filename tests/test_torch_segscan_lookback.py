"""The single-pass scans' decomposition against the JAX reference, bit for
bit.

``csrc/segscan.cu``'s FIFO, stack and tiered kernels scan tiles of
threads x items ops: each thread composes its ops serially, warps scan in
lane order, and a decoupled look-back composes each tile's predecessors
in windows of 32, stopping at the nearest one that has published its
inclusive prefix.  ``queue_scan_lookback_model``,
``stack_scan_lookback_model`` and ``tiered_scan_lookback_model``
(``repro_torch.kernels.segscan.ref``) bracket the scans the same way in
plain torch, with the set of predecessors a tile finds inclusive drawn
at random (on the card it is timing).  The same numpy inputs go through
them and through ``repro.core.scan_queue.queue_scan`` and ``stack_scan``,
``queue_scan_pallas``, ``stack_scan_pallas`` and
``tiered_queue_scan_pallas`` (interpret mode).  n sits at a tile's edges
and at 34 and 70 tiles, where a look-back crosses a window.  The tiered
launcher's grouping of more than 256 tiers (``tier_groups``) runs here
over the plain sweep and the model, against the Pallas sweep and the
reference's per-tier loop (``repro.core.scan_queue.priority_queue_scan``).
All outputs are integers: the tolerance is zero.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.scan_queue import QueueState as JQueueState
from repro.core.scan_queue import StackState as JStackState
from repro.core.scan_queue import priority_queue_scan as j_pq_scan
from repro.core.scan_queue import queue_scan as _j_queue_scan
from repro.core.scan_queue import stack_scan as _j_stack_scan
from repro.kernels.segscan import (queue_scan_pallas, stack_scan_pallas,
                                   tiered_queue_scan_pallas)

from repro_torch.core.scan_queue import priority_queue_scan
from repro_torch.kernels import backend
from repro_torch.kernels.segscan import tiered_queue_scan_ref
from repro_torch.kernels.segscan.kernel import (MAX_TIERS, QUEUE_THREADS,
                                                STACK_THREADS, TIER_THREADS,
                                                TILE, tier_groups)
from repro_torch.kernels.segscan.ref import (QUEUE_ITEMS, STACK_ITEMS,
                                             TIER_ITEMS, WINDOW,
                                             queue_scan_lookback_model,
                                             stack_scan_lookback_model,
                                             tiered_scan_lookback_model)

j_queue_scan = jax.jit(_j_queue_scan)
j_stack_scan = jax.jit(_j_stack_scan)

# (case, n): a tile's edges, then 34 and 70 tiles (windows of 32 crossed)
QUEUE_CASES = [("mixed65", TILE - 1), ("deq_only", TILE),
               ("valid80", TILE + 1), ("mixed65", 34 * TILE + 5),
               ("deq_heavy", 34 * TILE + 5), ("valid80", 70 * TILE)]
# the empty queue, a live window, and one near 2^29 (B's INF + last stays
# below 2^31)
QUEUE_STATES = [(0, -1), (1_000_000, 1_005_000), (2 ** 29 - 3000, 2 ** 29)]


def _queue_case(name, n, seed):
    """(is_enq, valid) from a seeded generator."""
    rng = np.random.default_rng(seed)
    if name == "mixed65":
        return rng.random(n) < 0.65, np.ones(n, bool)
    if name == "deq_only":
        return np.zeros(n, bool), np.ones(n, bool)
    if name == "valid80":
        return rng.random(n) < 0.5, rng.random(n) < 0.8
    if name == "deq_heavy":            # the queue runs dry and ⊥s follow
        return rng.random(n) < 0.2, rng.random(n) < 0.95
    raise KeyError(name)


def _queue_model(case, n, state, seed, p_inclusive):
    e, v = _queue_case(case, n, seed)
    got = queue_scan_lookback_model(
        torch.from_numpy(e), torch.from_numpy(v), _i32(state[0]),
        _i32(state[1]), p_inclusive=p_inclusive, seed=seed)
    return (e, v), got


@pytest.mark.parametrize("p_inclusive", [0.0, 0.7])
@pytest.mark.parametrize("state", QUEUE_STATES)
@pytest.mark.parametrize("case,n", QUEUE_CASES)
def test_queue_model_matches_jax_core(case, n, state, p_inclusive):
    (e, v), got = _queue_model(case, n, state, n + state[0], p_inclusive)
    jp, jm, jn = j_queue_scan(jnp.asarray(e),
                              JQueueState(jnp.int32(state[0]),
                                          jnp.int32(state[1])),
                              valid=jnp.asarray(v))
    assert got[0].dtype == got[2].dtype == got[3].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jm))
    assert (int(got[2]), int(got[3])) == (int(jn.first), int(jn.last))
    if case == "deq_heavy" and state == (0, -1):
        assert not got[1].all() and got[1].any()   # ⊥s and matches


@pytest.mark.parametrize("p_inclusive", [0.3, 1.0])
@pytest.mark.parametrize("case,n", QUEUE_CASES)
def test_queue_model_matches_pallas_interpret(case, n, p_inclusive):
    """Some predecessors inclusive, or all (each look-back stops at the
    nearest tile)."""
    for state in QUEUE_STATES:
        (e, v), got = _queue_model(case, n, state, n + 1, p_inclusive)
        want = queue_scan_pallas(jnp.asarray(e), jnp.asarray(v),
                                 jnp.int32(state[0]), jnp.int32(state[1]),
                                 interpret=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


STACK_CASES = [("mixed65", TILE - 1), ("push_prefix", TILE),
               ("pop_only", TILE + 1), ("valid80", 34 * TILE + 5),
               ("mixed65", 34 * TILE + 5), ("ticket_wraps", 70 * TILE),
               ("push_prefix", 70 * TILE)]


def _stack_case(name, n, seed):
    """(is_push, valid, last, ticket) from a seeded generator."""
    rng = np.random.default_rng(seed)
    if name == "mixed65":
        return rng.random(n) < 0.65, np.ones(n, bool), 0, 0
    if name == "push_prefix":          # b of the prefix sits near -INF
        e = rng.random(n) < 0.3
        e[:n * 3 // 5] = True
        v = rng.random(n) < 0.9
        v[:n * 3 // 5] = True
        return e, v, 0, 0
    if name == "pop_only":
        return np.zeros(n, bool), np.ones(n, bool), 1000, 7
    if name == "valid80":
        return rng.random(n) < 0.5, rng.random(n) < 0.8, 1_000_000, 5_000_000
    if name == "ticket_wraps":
        return rng.random(n) < 0.8, np.ones(n, bool), 10, 2 ** 31 - 1000
    raise KeyError(name)


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _model(case, n, seed, p_inclusive):
    e, v, last, tick = _stack_case(case, n, seed)
    got = stack_scan_lookback_model(torch.from_numpy(e), torch.from_numpy(v),
                                    _i32(last), _i32(tick),
                                    p_inclusive=p_inclusive, seed=seed)
    return (e, v, last, tick), got


@pytest.mark.parametrize("p_inclusive", [0.0, 0.7])
@pytest.mark.parametrize("case,n", STACK_CASES)
def test_stack_model_matches_jax_core(case, n, p_inclusive):
    (e, v, last, tick), got = _model(case, n, n, p_inclusive)
    jp, jt, jm, jn = j_stack_scan(jnp.asarray(e),
                                  JStackState(jnp.int32(last),
                                              jnp.int32(tick)),
                                  valid=jnp.asarray(v))
    assert all(x.dtype == torch.int32 for x in got[:2] + got[3:])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jm))
    assert (int(got[3]), int(got[4])) == (int(jn.last), int(jn.ticket))
    if case == "ticket_wraps":
        assert int(got[4]) < 0                 # the ticket did wrap


@pytest.mark.parametrize("case,n", STACK_CASES)
def test_stack_model_matches_pallas_interpret(case, n):
    (e, v, last, tick), got = _model(case, n, n + 1, 0.3)
    want = stack_scan_pallas(jnp.asarray(e), jnp.asarray(v),
                             jnp.int32(last), jnp.int32(tick),
                             interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tier_case(n, P, seed):
    """Enqueue flags (80% of ops), tiers in [-2, P + 2) (out-of-range ones
    included), lasts with one near the int32 edge (the sweep wraps)."""
    rng = np.random.default_rng(seed)
    enq = rng.random(n) < 0.8
    tier = rng.integers(-2, P + 2, n).astype(np.int32)
    lasts = rng.integers(-1, 1000, P).astype(np.int32)
    lasts[0] = 2 ** 31 - 10
    return enq, tier, lasts


@pytest.mark.parametrize("n,P", [
    (n, P) for n in (TILE - 1, TILE, TILE + 1) for P in (1, 4, 64, MAX_TIERS)
] + [(34 * TILE + 5, 4), (34 * TILE + 5, 64), (70 * TILE, 1)])
def test_tiered_model_matches_pallas_interpret(n, P):
    enq, tier, lasts = _tier_case(n, P, seed=n + P)
    for p_inclusive in (0.0, 0.5):
        got = tiered_scan_lookback_model(
            torch.from_numpy(enq), torch.from_numpy(tier),
            torch.from_numpy(lasts), p_inclusive=p_inclusive, seed=P)
        if p_inclusive == 0.0:
            want = [np.asarray(x) for x in tiered_queue_scan_pallas(
                jnp.asarray(enq), jnp.asarray(tier), jnp.zeros(P, jnp.int32),
                jnp.asarray(lasts), P, interpret=True)]
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def _grouped(group, scan=tiered_queue_scan_ref):
    """The launcher's grouping over ``scan``, ``group`` tiers a call."""
    return lambda enq, tier, lasts: tier_groups(scan, enq, tier, lasts,
                                                group)


def _model_scan(enq, tier, lasts):
    assert lasts.shape[0] <= MAX_TIERS
    return tiered_scan_lookback_model(enq, tier, lasts, p_inclusive=0.5,
                                      seed=lasts.shape[0])


@pytest.mark.parametrize("n,P", [(TILE + 1, 257), (2 * TILE + 3, 512),
                                 (1500, 300)])
def test_tier_groups_match_pallas_interpret(n, P):
    """More tiers than one launch takes: groups of 256 (the card's), of 3
    (many groups over the plain sweep), and of 256 over the model of the
    kernel, against the reference's one Pallas sweep."""
    enq, tier, lasts = _tier_case(n, P, seed=n + P)
    lasts[-1] = 2 ** 31 - 3               # the last group wraps too
    want = [np.asarray(x) for x in tiered_queue_scan_pallas(
        jnp.asarray(enq), jnp.asarray(tier), jnp.zeros(P, jnp.int32),
        jnp.asarray(lasts), P, interpret=True)]
    args = [torch.from_numpy(x) for x in (enq, tier, lasts)]
    for scan in (_grouped(MAX_TIERS), _grouped(3),
                 _grouped(MAX_TIERS, _model_scan)):
        got = scan(*args)
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("group", [MAX_TIERS, 5])
@pytest.mark.parametrize("P", [257, 512])
def test_grouped_priority_scan_matches_per_tier_loop(P, group):
    """The strict P-tier scan with the grouped sweep as its enqueue hook
    against the reference's own oracle, one masked FIFO scan per tier (run
    eagerly: traced, 512 scans take minutes to compile)."""
    rng = np.random.default_rng(P + group)
    n = 1200
    is_enq, valid = rng.random(n) < 0.6, rng.random(n) < 0.9
    prio = rng.integers(0, P, n).astype(np.int32)
    prio[:8] = P - 1                   # enqueues in the last group's tiers
    firsts = rng.integers(0, 100, P).astype(np.int32)
    lasts = (firsts + rng.integers(-1, 30, P)).astype(np.int32)
    want = j_pq_scan(*(jnp.asarray(x) for x in (is_enq, prio, valid, firsts,
                                                lasts)), n_prios=P)
    got = priority_queue_scan(
        *(torch.from_numpy(x) for x in (is_enq, prio, valid, firsts, lasts)),
        n_prios=P, tier_scan=lambda e, t, f, l: tier_groups(
            tiered_queue_scan_ref, e, t, l, group))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (got[0] == P - 1).any()     # placed past tier 255


def test_models_bracket_as_the_kernel_source():
    """The launcher's tile constants, which the models take (FIFO and
    tiered: 256 threads x 16 ops; stack: 128 x 32), and the models' window
    (32) are the ones csrc/segscan.cu uses."""
    src = (backend.CSRC / "segscan.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\w+);", src))
    assert int(const["kTile"]) == TILE == STACK_THREADS * STACK_ITEMS \
        == TIER_THREADS * TIER_ITEMS == QUEUE_THREADS * QUEUE_ITEMS
    assert int(const["kQueueThreads"]) == QUEUE_THREADS
    assert int(const["kStackThreads"]) == STACK_THREADS
    assert int(const["kTierThreads"]) == TIER_THREADS
    assert const["kMaxTiers"] == "kTierThreads" and MAX_TIERS == 256
    assert f"top -= {WINDOW}" in src           # the look-back window
