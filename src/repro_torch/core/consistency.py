"""Sequential-consistency checker (paper Definition 1, Theorems 14/21).

Counterpart of ``repro/core/consistency.py``.

Strategy: the protocol materializes ``value(op)`` (the paper's Section-V
virtual-counter order ``≺``) for every processed request.  We *replay* all
requests in increasing ``value`` order against a reference sequential
queue/stack and demand that every request's protocol result is identical to
the reference result.  Replay equality implies Definition-1 properties 1–3
(FIFO matching, no skipped elements, no crossing matchings); property 4
(per-source program order embeds into ``≺``) is checked directly.

Locally-combined stack pairs (Sec. VI local pairing, ``order == -1``) are
net-zero on the stack and provably placeable adjacently anywhere consistent
with program order; they are validated pairwise instead of replayed.
"""
from __future__ import annotations

from collections import deque
from typing import List

from .intervals import BOTTOM
from .protocol import Skueue


class ConsistencyViolation(AssertionError):
    pass


def check_sequential_consistency(sk: Skueue) -> dict:
    reqs = [r for r in sk.requests if r.done]
    if any(not r.done for r in sk.requests):
        raise ConsistencyViolation("unfinished requests — run to quiescence first")

    paired = [r for r in reqs if r.order == -1]
    global_reqs = [r for r in reqs if r.order != -1]

    # locally-combined pairs: pop must return the locally paired push's element
    pops = [r for r in paired if r.kind == "deq"]
    pushes = {r.elem: r for r in paired if r.kind == "enq"}
    for p in pops:
        if p.result not in pushes:
            raise ConsistencyViolation(f"local pair mismatch for request {p.rid}")

    # uniqueness of the order values
    orders = [r.order for r in global_reqs]
    if len(set(orders)) != len(orders):
        raise ConsistencyViolation("value(op) not unique")

    # property 4: per-source program order embeds into ≺
    by_node: dict = {}
    for r in sk.requests:  # use full issue sequence, in issue order (rid order)
        by_node.setdefault(r.node, []).append(r)
    for node, seq in by_node.items():
        vals = [r.order for r in seq if r.order is not None and r.order != -1]
        if any(b <= a for a, b in zip(vals, vals[1:])):
            raise ConsistencyViolation(f"program order violated at node {node}")

    # properties 1-3 via replay
    global_reqs.sort(key=lambda r: r.order)
    if sk.mode == "queue":
        ref: deque = deque()
        for r in global_reqs:
            if r.kind == "enq":
                ref.append(r.elem)
            else:
                expect = ref.popleft() if ref else BOTTOM
                if r.result != expect:
                    raise ConsistencyViolation(
                        f"queue replay mismatch at rid={r.rid}: "
                        f"protocol={r.result} reference={expect}")
    else:
        ref_stack: List[int] = []
        for r in global_reqs:
            if r.kind == "enq":
                ref_stack.append(r.elem)
            else:
                expect = ref_stack.pop() if ref_stack else BOTTOM
                if r.result != expect:
                    raise ConsistencyViolation(
                        f"stack replay mismatch at rid={r.rid}: "
                        f"protocol={r.result} reference={expect}")

    return {
        "n_requests": len(reqs),
        "n_locally_paired": len(paired),
        "max_batch_runs": sk.stats_batch_max_runs,
        "total_msgs": sk.total_msgs,
    }
