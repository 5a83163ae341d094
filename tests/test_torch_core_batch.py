"""The port's batch algebra (Definition 5) and interval stages (Sections
III-D/E, VI): the reference's cases on ``repro_torch.core``, and the
stages' outputs equal to ``repro.core``'s on random runs (integers: the
tolerance is zero)."""
import numpy as np
from _hyp import given, settings, strategies as st

from repro.core import batch as RB
from repro.core import intervals as RI

from repro_torch.core import batch as B
from repro_torch.core.intervals import (AnchorState, BOTTOM, assign_queue,
                                        assign_stack, decompose_queue,
                                        decompose_stack, positions_queue,
                                        positions_stack)


def _runs(ops):
    runs = B.empty()
    for op in ops:
        B.append_op(runs, op)
    return runs


def test_append_and_totals():
    runs = _runs((True, True, False, True, False, False))
    assert runs == [2, 1, 1, 2]
    assert B.totals(runs) == (3, 3)


def test_combine_padding():
    assert B.combine([1, 2], [3]) == [4, 2]
    assert B.combine([0], [1, 1, 5]) == [1, 1, 5]
    assert B.combine_many([[1], [0, 2], [1, 1, 1]]) == [2, 3, 1]


@given(st.lists(st.booleans(), max_size=60))
@settings(max_examples=50, deadline=None)
def test_batch_respects_local_order(ops):
    """The run-length encoding reproduces the op sequence exactly."""
    runs = _runs(ops)
    decoded = []
    for i, r in enumerate(runs):
        decoded += [i % 2 == 0] * r
    assert decoded == ops or (not ops and decoded == [])


@given(st.lists(st.booleans(), min_size=1, max_size=40), st.integers(0, 20))
@settings(max_examples=80, deadline=None)
def test_queue_assignment_matches_sequential(ops, pre):
    """Stage-2 intervals = serializing all ops one by one at the anchor."""
    runs = _runs(ops)
    st_state = AnchorState(first=0, last=pre - 1)  # pre elements inside
    pos = positions_queue(assign_queue(st_state, runs), runs)
    f, l = 0, pre - 1
    for op, p in zip(ops, pos):
        if op:  # enqueue
            l += 1
            assert p == l
        elif f <= l:
            assert p == f
            f += 1
        else:
            assert p == BOTTOM
    assert st_state.first == f and st_state.last == l


@given(st.lists(st.lists(st.booleans(), max_size=12), min_size=1, max_size=5))
@settings(max_examples=60, deadline=None)
def test_decompose_covers_combined_exactly(parts_ops):
    """Stage 3: sub-intervals partition the combined intervals; every enqueue
    position unique; dequeues clamp exactly at interval end."""
    parts = [_runs(ops) for ops in parts_ops]
    state = AnchorState(first=0, last=4)  # 5 elements in the queue
    sub = decompose_queue(assign_queue(state, B.combine_many(parts)), parts)
    enq_positions, deq_positions = [], []
    for part, sub_iv in zip(parts, sub):
        pos = positions_queue(sub_iv, part)
        k = 0
        for i, r in enumerate(part):
            for _ in range(r):
                (enq_positions if i % 2 == 0 else deq_positions).append(pos[k])
                k += 1
    assert len(enq_positions) == len(set(enq_positions))
    real_deq = [p for p in deq_positions if p != BOTTOM]
    assert len(real_deq) == len(set(real_deq))
    if real_deq:
        assert min(real_deq) == 0  # queue head was 0


def test_stack_tickets_monotone():
    state = AnchorState(first=0, last=0, ticket=0)
    info = assign_stack(state, [3, 2, 2, 4])  # push 3, pop 2, push 2, pop 4
    assert (*info[0][0], info[0][1]) == (1, 3, 1)
    assert (*info[1][0], info[1][1]) == (2, 3, 3)   # pops take the top two
    assert (*info[2][0], info[2][1]) == (2, 3, 4)   # fresh tickets
    assert info[3][0] == (1, 3) and info[3][1] == 5
    assert state.last == 0 and state.ticket == 5


@given(st.lists(st.booleans(), min_size=1, max_size=30))
@settings(max_examples=80, deadline=None)
def test_stack_assignment_matches_sequential(ops):
    runs = _runs(ops)
    state = AnchorState(first=0, last=0, ticket=0)
    pts = positions_stack(assign_stack(state, runs), runs)
    ref, tick = [], 0
    for op, (p, t) in zip(ops, pts):
        if op:
            tick += 1
            ref.append((len(ref) + 1, tick))
            assert (p, t) == ref[-1]
        elif ref:
            rp, rt = ref.pop()
            assert p == rp and t >= rt  # bound admits the element
        else:
            assert p == BOTTOM


def test_stack_batch_constant_size():
    """Theorem 20: after local pairing the buffered sequence is pops then
    pushes, at most 3 runs (an empty push run first)."""
    runs = _runs([False] * 5 + [True] * 7)
    assert len(runs) == 3 and runs[0] == 0  # (0 push, 5 pop, 7 push)


# ------------------------------------------- against the reference --------
@given(st.lists(st.lists(st.booleans(), max_size=16), min_size=1, max_size=6),
       st.integers(0, 30), st.integers(0, 30))
@settings(max_examples=80, deadline=None)
def test_stages_equal_reference(parts_ops, pre, ticket):
    """``assign_*``, ``decompose_*``, ``positions_*``, the batch algebra
    and ``BatchMsg`` give the reference's values and anchor states."""
    parts = [_runs(ops) for ops in parts_ops]
    ref_parts = []
    for ops in parts_ops:
        runs = RB.empty()
        for op in ops:
            RB.append_op(runs, op)
        ref_parts.append(runs)
    assert parts == ref_parts
    combined = B.combine_many(parts)
    assert combined == RB.combine_many(ref_parts)
    assert [B.totals(p) for p in parts] == [RB.totals(p) for p in parts]
    assert np.array_equal(B.as_array(combined, 40),
                          RB.as_array(combined, 40))
    a, b = B.BatchMsg(parts[0], 1, 2), B.BatchMsg(parts[-1], 3, 0)
    ra, rb = RB.BatchMsg(parts[0], 1, 2), RB.BatchMsg(parts[-1], 3, 0)
    c, rc = a.combined_with(b), ra.combined_with(rb)
    assert (c.runs, c.joins, c.leaves, c.empty) == (
        rc.runs, rc.joins, rc.leaves, rc.empty)

    q, rq = (AnchorState(first=2, last=pre + 1),
             RI.AnchorState(first=2, last=pre + 1))
    ivs, r_ivs = assign_queue(q, combined), RI.assign_queue(rq, combined)
    assert ivs == r_ivs and (q.first, q.last, q.size) == (
        rq.first, rq.last, rq.size)
    sub = decompose_queue(ivs, parts)
    assert sub == RI.decompose_queue(r_ivs, parts)
    for s, p in zip(sub, parts):
        assert positions_queue(s, p) == RI.positions_queue(s, p)

    s_, rs = (AnchorState(first=0, last=pre, ticket=pre + ticket),
              RI.AnchorState(first=0, last=pre, ticket=pre + ticket))
    info, r_info = assign_stack(s_, combined), RI.assign_stack(rs, combined)
    assert info == r_info and (s_.last, s_.ticket) == (rs.last, rs.ticket)
    sub = decompose_stack(info, parts)
    assert sub == RI.decompose_stack(r_info, parts)
    for s, p in zip(sub, parts):
        assert positions_stack(s, p) == RI.positions_stack(s, p)
