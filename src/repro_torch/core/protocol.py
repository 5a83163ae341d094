"""SKUEUE protocol engine (paper Sections III, IV, VI) — faithful implementation.

Counterpart of ``repro/core/protocol.py``: host bookkeeping in plain
Python, numpy and ``heapq``, message for message the reference's (the
same generator draws, heap tuples, send order and child-dict order), so
both give the same records on the same schedule.

One implementation of the message-passing protocol, driven by two schedulers:

* ``run_async``  — adversarial asynchronous delivery (arbitrary finite delays,
  non-FIFO channels).  Used by the hypothesis property tests to validate
  sequential consistency (Definition 1 / Theorems 14 & 21).
* ``run_rounds`` — the standard synchronous model used for the paper's
  runtime analysis and evaluation (Figures 2/3/4): messages sent in round i
  arrive in round i+1; every node fires TIMEOUT each round.

Fidelity notes:
- Stages 1–4 follow Algorithms 1–2 exactly: empty batch waves, memorized
  sub-batch combination order, dequeue clamping, and — stack — the stage-4
  completion barrier, monotone tickets and local push/pop combining.
- DHT PUT/GET are delivered with a transit delay equal to the LDB De Bruijn
  route length (Lemma 3) instead of hop-by-hop forwarding; GETs that outrun
  their PUT wait at the owner exactly as in the paper; messages that land on
  a node that no longer owns the key are forwarded (Sec. IV).
- JOIN/LEAVE (Sec. IV) are lazy: responsible nodes buffer joiners/leavers and
  report counts ``B.j``/``B.l`` in their batches; the anchor raises the
  update flag on the next serve wave; nodes freeze after that wave's stage 4,
  integrate the nodes they are responsible for, and ack up the OLD tree; the
  anchor (possibly handing off to a new leftmost node) broadcasts resume down
  the NEW tree.  Simplifications vs. the paper:
  data moves at integration (not at join-accept); a leaving node is merged
  into its predecessor (interval-equivalent to the paper's replacement node);
  busy leavers are deferred to the next update phase (subsumes the paper's
  leave-prioritisation rule); the message-drain acknowledgment machinery is
  replaced by arrival-time forwarding, which is equivalent under reliable
  channels.
- The anchor's virtual counter ``c`` (Section V) is materialized by carrying
  an *order interval* alongside each position interval, decomposed with the
  same leading-slice rule; this yields ``value(op)`` for every request, i.e.
  the total order ``≺`` that the consistency checker replays.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import batch as B
from .hashing import position_key
from .intervals import (AnchorState, BOTTOM, assign_queue, assign_stack,
                        decompose_queue, decompose_stack, positions_queue,
                        positions_stack)
from .ring import DynamicRing

ENQ, DEQ = "enq", "deq"


@dataclass
class Request:
    rid: int
    kind: str              # "enq" | "deq"  (also used for push/pop)
    node: int              # issuing virtual node (stable id)
    elem: Optional[int]    # element id for enqueues
    t_issue: int = 0       # round (sync) / event step (async)
    t_done: int = -1
    pos: Optional[int] = None
    order: Optional[int] = None   # value(op) — the protocol's total order
    result: Optional[int] = None  # dequeue: element id, or BOTTOM for ⊥
    done: bool = False


class Skueue:
    """A full SKUEUE instance, initially over ``n`` processes (3n nodes)."""

    def __init__(self, n: int, mode: str = "queue", seed: int = 0,
                 salt: int = 0, local_combining: bool = True):
        assert mode in ("queue", "stack")
        self.mode = mode
        self.ring = DynamicRing.build(n, salt=salt)
        self.rng = np.random.default_rng(seed)
        self.next_pid = n
        # --- per-node protocol state (lists grow with joins) ---
        M = len(self.ring.labels)
        self.W_own_reqs: List[List[int]] = [[] for _ in range(M)]
        self.W_child: List[Dict[int, List[int]]] = [dict() for _ in range(M)]
        self.B_own_reqs: List[List[int]] = [[] for _ in range(M)]
        self.B_child: List[Dict[int, List[int]]] = [dict() for _ in range(M)]
        self.B_child_order: List[List[int]] = [[] for _ in range(M)]
        self.busy: List[bool] = [False] * M
        self.frozen: List[bool] = [False] * M
        self.stage4_open: List[int] = [0] * M
        # --- DHT state (keyed by position; key k(p) only selects the owner) --
        self.store: List[Dict[int, object]] = [dict() for _ in range(M)]
        self.pending_get: List[Dict[int, List[int]]] = [dict() for _ in range(M)]
        self.pending_pop: List[List[Tuple[int, int, int]]] = [[] for _ in range(M)]
        # --- membership (Sec. IV) ---
        self.pending_joins: List[List[int]] = [[] for _ in range(M)]
        self.pending_leaves: List[List[int]] = [[] for _ in range(M)]
        self.leaving: List[bool] = [False] * M
        self.j_report: List[int] = [0] * M      # B.j since last batch
        self.l_report: List[int] = [0] * M      # B.l since last batch
        self.p_old: List[int] = [-2] * M        # serve-time parent in update phase
        self.agg_parent: List[int] = [-1] * M   # parent the last aggregate went to
        self.C_old: List[List[int]] = [[] for _ in range(M)]
        self.acks_got: List[int] = [0] * M
        self.integ_done: List[int] = [0] * M    # integrated count to report
        self.fwd_to: List[int] = [-1] * M       # post-leave forwarding pointer
        self.update_active = False
        self.pending_membership = 0             # anchor's known-uncompleted count
        self.update_phases = 0
        # --- anchor ---
        # queue: occupied = [first, last], empty at (0, -1).
        # stack: positions start at 1, empty at last=0 (paper Sec. VI).
        self.anchor_state = AnchorState(first=0, last=(-1 if mode == "queue" else 0))
        self.anchor_id = self.ring.anchor
        self.order_counter = 0   # the paper's virtual counter c
        # --- requests & messages ---
        self.requests: List[Request] = []
        self.local_combining = local_combining and mode == "stack"
        self.now = 0
        self.msgs_heap: List[Tuple[int, int, int, tuple]] = []  # (due, seq, dst, msg)
        self._seq = 0
        self.stats_batch_max_runs = 0
        self.total_msgs = 0

    # ---------------------------------------------------------- node state --
    def _grow_state(self) -> None:
        M = len(self.ring.labels)
        while len(self.busy) < M:
            self.W_own_reqs.append([])
            self.W_child.append(dict())
            self.B_own_reqs.append([])
            self.B_child.append(dict())
            self.B_child_order.append([])
            self.busy.append(False)
            self.frozen.append(True)   # new nodes wait for resume
            self.stage4_open.append(0)
            self.store.append(dict())
            self.pending_get.append(dict())
            self.pending_pop.append([])
            self.pending_joins.append([])
            self.pending_leaves.append([])
            self.leaving.append(False)
            self.j_report.append(0)
            self.l_report.append(0)
            self.p_old.append(-2)
            self.agg_parent.append(-1)
            self.C_old.append([])
            self.acks_got.append(0)
            self.integ_done.append(0)
            self.fwd_to.append(-1)

    # ------------------------------------------------------------- inject --
    def inject(self, node: int, kind: str, elem: Optional[int] = None) -> int:
        assert self.ring.active[node], "cannot inject at an inactive node"
        rid = len(self.requests)
        if kind == ENQ and elem is None:
            elem = rid  # unique element id (paper: elements unique w.l.o.g.)
        req = Request(rid=rid, kind=kind, node=node, elem=elem, t_issue=self.now)
        self.requests.append(req)
        own = self.W_own_reqs[node]
        if self.local_combining and kind == DEQ and own:
            # Stack local pairing (Sec. VI): a pop answers the latest
            # still-buffered local push.
            prev = self.requests[own[-1]]
            if prev.kind == ENQ:
                own.pop()
                prev.done, prev.t_done, prev.order = True, self.now, -1
                req.done, req.t_done, req.result, req.order = (
                    True, self.now, prev.elem, -1)
                return rid
        own.append(rid)
        return rid

    # -------------------------------------------------------- membership ---
    def request_join(self, pid: Optional[int] = None) -> List[int]:
        """A new process joins: three virtual nodes, each routed (Lemma 3) to
        its responsible node.  Returns the new virtual node ids."""
        if pid is None:
            pid = self.next_pid
        self.next_pid = max(self.next_pid, pid + 1)
        trio = self.ring.add_process(pid, activate=False)
        self._grow_state()
        for nid in trio:
            key = self.ring.labels[nid]
            owner = self.ring.owner_of_scalar(key)
            delay = 1 + self.ring.route_hops_scalar(owner, key)
            self._send(owner, ("join", nid), delay=delay)
        return list(trio)

    def request_leave(self, pid: int) -> None:
        """Process ``pid`` wants to leave: LEAVE() for its three nodes."""
        trios = [nid for nid, p in enumerate(self.ring.proc)
                 if p == pid and self.ring.active[nid]]
        for nid in trios:
            u = self.ring.pred(nid)
            self._send(u, ("leave", nid), delay=1)

    # ----------------------------------------------------------- messaging --
    def _send(self, dst: int, msg: tuple, delay: int = 1) -> None:
        self._seq += 1
        self.total_msgs += 1
        heapq.heappush(self.msgs_heap, (self.now + delay, self._seq, dst, msg))

    # ------------------------------------------------------------ TIMEOUT --
    def timeout(self, v: int) -> None:
        """Algorithm 1: if B=(0) and W has sub-batches from all children
        (and, stack, all stage-4 ops acked) -> B <- W, send AGGREGATE."""
        if (self.busy[v] or self.frozen[v] or self.stage4_open[v] > 0
                or not self.ring.active[v]):
            return
        kids = self.ring.children(v)
        if any(c not in self.W_child[v] for c in kids):
            return
        self.B_own_reqs[v] = self.W_own_reqs[v]
        self.W_own_reqs[v] = []
        # consume required children plus any orphaned sub-batches forwarded by
        # ex-children after a membership change (they must not be lost)
        take = list(kids) + [c for c in self.W_child[v] if c not in kids]
        self.B_child[v] = {c: self.W_child[v].pop(c) for c in take}
        self.B_child_order[v] = take
        self.busy[v] = True
        j, l = self.j_report[v], self.l_report[v]
        self.j_report[v] = 0
        self.l_report[v] = 0
        runs, jt, lt = self._combined_runs(v, j, l)
        self.stats_batch_max_runs = max(self.stats_batch_max_runs, len(runs))
        if v == self.anchor_id:
            self.agg_parent[v] = -1
            self.pending_membership += jt + lt
            self._assign_and_serve(v, runs)
        else:
            p = self.ring.parent(v)
            self.agg_parent[v] = p  # the OLD-tree parent for update-phase acks
            self._send(p, ("aggregate", v, runs, jt, lt))

    def _runs_of(self, rids: List[int]) -> List[int]:
        runs = B.empty()
        for rid in rids:
            B.append_op(runs, self.requests[rid].kind == ENQ)
        return runs

    def _combined_runs(self, v: int, j: int, l: int):
        parts = [self._runs_of(self.B_own_reqs[v])]
        jt, lt = j, l
        for c in self.B_child_order[v]:
            runs_c, j_c, l_c = self.B_child[v][c]
            parts.append(runs_c)
            jt += j_c
            lt += l_c
        return B.combine_many(parts), jt, lt

    # -------------------------------------------------------- stages 2 + 3 --
    def _assign_and_serve(self, v: int, runs: List[int]) -> None:
        """Stage 2 at the anchor, then recursive SERVE (Algorithm 2)."""
        norm = list(runs)
        if self.mode == "queue":
            ivs = assign_queue(self.anchor_state, norm)
        else:
            ivs = assign_stack(self.anchor_state, norm)
        orders = []
        c = self.order_counter
        for op in norm:
            orders.append((c + 1, c + int(op)))
            c += int(op)
        self.order_counter = c
        flag = self.pending_membership > 0
        if flag:
            self.update_active = True
            self.update_phases += 1
        self._serve(v, ivs, orders, flag)

    def _serve(self, v: int, ivs, orders, flag: bool) -> None:
        own_runs = self._runs_of(self.B_own_reqs[v])
        parts = [own_runs] + [self.B_child[v][c][0] for c in self.B_child_order[v]]
        if self.mode == "queue":
            sub = decompose_queue(ivs, parts)
        else:
            sub = decompose_stack(ivs, parts)
        sub_orders = decompose_queue(orders, parts)
        for i, c in enumerate(self.B_child_order[v]):
            self._send(c, ("serve", sub[i + 1], sub_orders[i + 1], flag))
        self._stage4(v, sub[0], sub_orders[0], own_runs)
        # return to stage 1 (or enter the update phase)
        self.B_own_reqs[v] = []
        self.B_child[v] = {}
        kids_served = self.B_child_order[v]
        self.B_child_order[v] = []
        if flag:
            self.frozen[v] = True
            # acks travel up the OLD aggregation tree (paper Sec. IV-A):
            # the parent this wave's aggregate was sent to, not the current one
            self.p_old[v] = -1 if v == self.anchor_id else self.agg_parent[v]
            self.C_old[v] = list(kids_served)
            self.acks_got[v] = 0
            self.integ_done[v] = 0
            self._integrate(v)
            self._maybe_ack(v)
        if self.stage4_open[v] == 0 and not self.frozen[v]:
            self.busy[v] = False
        elif self.stage4_open[v] == 0 and self.frozen[v]:
            self.busy[v] = False  # wave is complete; freeze blocks the next one

    # ------------------------------------------------------------ stage 4 --
    def _stage4(self, v: int, run_info, run_orders, own_runs) -> None:
        rids = self.B_own_reqs[v]
        if self.mode == "queue":
            pos = positions_queue(run_info, own_runs)
            pt = [(p, 0) for p in pos]
        else:
            pt = positions_stack(run_info, own_runs)
        ordvals: List[int] = []
        for i, op in enumerate(own_runs):
            x, _y = run_orders[i]
            ordvals += [x + j for j in range(int(op))]
        assert len(pt) == len(rids) == len(ordvals)
        for rid, (p, t), val in zip(rids, pt, ordvals):
            req = self.requests[rid]
            req.pos, req.order = (None if p == BOTTOM else p), val
            if p == BOTTOM:  # unmatched dequeue: returns ⊥ immediately
                req.result, req.done, req.t_done = BOTTOM, True, self.now
                continue
            key = float(position_key(p))
            owner = self.ring.owner_of_scalar(key)
            delay = 1 + self.ring.route_hops_scalar(v, key)
            if req.kind == ENQ:
                self._send(owner, ("put", p, t, req.elem, rid, v), delay=delay)
                if self.mode == "stack":
                    self.stage4_open[v] += 1
            else:
                self._send(owner, ("get", p, t, rid, v), delay=delay)
                if self.mode == "stack":
                    self.stage4_open[v] += 1

    # ------------------------------------------------- update phase helpers --
    def _integrate(self, v: int) -> None:
        """Integrate all joiners/leavers this node is responsible for."""
        # Activate joiners right-to-left so that at each activation the new
        # node's key interval still lives on ``v`` (paper: chain introduction
        # v_1 < ... < v_k between u and succ(u)).
        for nid in sorted(self.pending_joins[v],
                          key=lambda i: -self.ring.labels[i]):
            self.ring.activate(nid)
            self.frozen[nid] = True
            succ = self.ring.succ(nid)
            self._move_interval(v, nid, self.ring.labels[nid],
                                self.ring.labels[succ] if succ != nid else None)
            self.integ_done[v] += 1
        self.pending_joins[v] = []
        # LEAVE (paper Sec. IV-B): the process emulating the left neighbour
        # creates a replacement v' with the same label, connections, DHT data
        # and responsibilities.  The virtual node therefore PERSISTS on the
        # ring — only its emulating process changes.  In the engine this is a
        # process re-assignment; the state handover that a real deployment
        # would stream over the network is atomic here.
        if self.leaving[v]:
            # leave-prioritisation (paper Sec. IV-B): a responsible node that
            # is itself leaving postpones replacing its neighbours until it
            # has been replaced — there is always a leftmost leaving node, so
            # this converges phase by phase.
            pass
        else:
            for nid in self.pending_leaves[v]:
                self.ring.proc[nid] = self.ring.proc[v]
                self.leaving[nid] = False
                self.integ_done[v] += 1
            self.pending_leaves[v] = []
        if self.mode == "stack":
            self._drain_pops(v)
        else:
            self._drain_gets(v)

    def _move_interval(self, src: int, dst: int, lo: float,
                       hi: Optional[float]) -> None:
        """Move stored elements + waiting GETs/POPs with key in [lo, hi)."""
        def mine(p: int) -> bool:
            k = float(position_key(p))
            if hi is None:
                return True
            if lo <= hi:
                return lo <= k < hi
            return k >= lo or k < hi  # wrap-around interval
        moved = [p for p in self.store[src] if mine(p)]
        for p in moved:
            self.store[dst][p] = self.store[src].pop(p)
        movedg = [p for p in self.pending_get[src] if mine(p)]
        for p in movedg:
            self.pending_get[dst][p] = self.pending_get[src].pop(p)
        keep, move = [], []
        for rec in self.pending_pop[src]:
            (move if mine(rec[0]) else keep).append(rec)
        self.pending_pop[src] = keep
        self.pending_pop[dst].extend(move)
        # re-match waiters that now share a node with their element
        if self.mode == "stack":
            self._drain_pops(dst)
        else:
            self._drain_gets(dst)

    def _maybe_ack(self, v: int) -> None:
        if not self.frozen[v] or self.p_old[v] == -2:
            return
        if self.acks_got[v] < len(self.C_old[v]):
            return
        if v == self.anchor_id:
            self._finish_update(v)
        else:
            self._send(self.p_old[v], ("uack", self.integ_done[v]))
            self.p_old[v] = -2
            # stay frozen until resume

    def _finish_update(self, old_anchor: int) -> None:
        total = self.integ_done[old_anchor]
        # integration counts reported by the subtree arrived via uack already.
        # May go negative: a node can integrate joiners/leavers it accepted
        # after its last batch report — the report arrives later as a credit.
        self.pending_membership -= total
        new_anchor = self.ring.anchor
        if new_anchor != old_anchor:
            # anchor handoff (Sec. IV-A): transfer [first,last] (+ticket, c)
            self._send(new_anchor, ("anchor_handoff",
                                    self.anchor_state.first,
                                    self.anchor_state.last,
                                    self.anchor_state.ticket,
                                    self.order_counter), delay=1)
        else:
            self._resume_from(new_anchor)
        self.p_old[old_anchor] = -2

    def _resume_from(self, v: int) -> None:
        self.update_active = False
        self.frozen[v] = False
        self.p_old[v] = -2
        for c in self.ring.children(v):
            self._send(c, ("resume",))

    # ----------------------------------------------------- message handler --
    def handle(self, dst: int, msg: tuple) -> None:
        kind = msg[0]
        if kind == "aggregate":
            _, child, runs, j, l = msg
            if not self.ring.active[dst] and self.fwd_to[dst] >= 0:
                self._send(self.fwd_to[dst], msg, delay=1)
                return
            assert child not in self.W_child[dst], "child double-send in a wave"
            self.W_child[dst][child] = (runs, j, l)
        elif kind == "serve":
            _, ivs, orders, flag = msg
            self._serve(dst, ivs, orders, flag)
        elif kind == "put":
            _, p, t, elem, rid, src = msg
            owner = self._current_owner(dst, p)
            if owner != dst:
                self._send(owner, msg, delay=1)
                return
            if self.mode == "queue":
                self.store[dst][p] = elem
                req = self.requests[rid]
                req.done, req.t_done = True, self.now
                waiters = self.pending_get[dst].pop(p, [])
                for wrid in waiters:
                    self._answer_get(dst, p, wrid)
            else:
                self.store[dst].setdefault(p, {})[t] = elem  # type: ignore
                self._send(src, ("ack_put", rid), delay=1)
                req = self.requests[rid]
                req.done, req.t_done = True, self.now
                self._drain_pops(dst)
        elif kind == "get":
            _, p, t, rid, src = msg
            owner = self._current_owner(dst, p)
            if owner != dst:
                self._send(owner, msg, delay=1)
                return
            if self.mode == "queue":
                if p in self.store[dst]:
                    self._answer_get(dst, p, rid)
                else:  # GET outran PUT: wait at the owner (paper Stage 4)
                    self.pending_get[dst].setdefault(p, []).append(rid)
            else:
                self.pending_pop[dst].append((p, t, rid))
                self._drain_pops(dst)
        elif kind == "elem":
            _, rid, elem = msg
            req = self.requests[rid]
            req.result, req.done, req.t_done = elem, True, self.now
            if self.mode == "stack":
                self._close_stage4(req.node)
        elif kind == "ack_put":
            _, rid = msg
            self._close_stage4(self.requests[rid].node)
        elif kind == "join":
            _, nid = msg
            if not self.ring.active[dst] and self.fwd_to[dst] >= 0:
                self._send(self.fwd_to[dst], msg, delay=1)
                return
            owner = self.ring.owner_of_scalar(self.ring.labels[nid])
            if owner != dst:  # responsibility moved meanwhile
                self._send(owner, msg, delay=1)
                return
            self.pending_joins[dst].append(nid)
            self.j_report[dst] += 1
        elif kind == "leave":
            _, nid = msg
            if not self.ring.active[dst] and self.fwd_to[dst] >= 0:
                self._send(self.fwd_to[dst], msg, delay=1)
                return
            if self.ring.pred(nid) != dst and self.ring.active[nid]:
                self._send(self.ring.pred(nid), msg, delay=1)
                return
            if not self.ring.active[nid] or self.leaving[nid]:
                return  # already gone / duplicate request
            self.leaving[nid] = True
            self.pending_leaves[dst].append(nid)
            self.l_report[dst] += 1
        elif kind == "uack":
            _, integrated = msg
            self.acks_got[dst] += 1
            self.integ_done[dst] += integrated
            self._maybe_ack(dst)
        elif kind == "anchor_handoff":
            _, first, last, ticket, c = msg
            self.anchor_state = AnchorState(first=first, last=last, ticket=ticket)
            self.order_counter = c
            old = self.anchor_id
            self.anchor_id = dst
            # the old anchor may still hold unreported membership counts
            self._resume_from(dst)
            if old != dst:
                self.frozen[old] = False
        elif kind == "resume":
            self.frozen[dst] = False
            self.p_old[dst] = -2
            for c in self.ring.children(dst):
                self._send(c, ("resume",))
        else:  # pragma: no cover
            raise ValueError(f"unknown message {kind}")

    def _current_owner(self, dst: int, p: int) -> int:
        if not self.ring.active[dst]:
            return self.fwd_to[dst] if self.fwd_to[dst] >= 0 else dst
        key = float(position_key(p))
        owner = self.ring.owner_of_scalar(key)
        return owner

    def _close_stage4(self, v: int) -> None:
        self.stage4_open[v] -= 1
        if self.stage4_open[v] == 0:
            self.busy[v] = False

    def _answer_get(self, owner: int, p: int, rid: int) -> None:
        elem = self.store[owner].pop(p)
        req = self.requests[rid]
        self._send(req.node, ("elem", rid, elem), delay=1)

    def _drain_gets(self, owner: int) -> None:
        """Queue: answer waiting GETs whose element has arrived/migrated."""
        ready = [p for p in self.pending_get[owner] if p in self.store[owner]]
        for p in ready:
            waiters = self.pending_get[owner].pop(p)
            for wrid in waiters:
                if p in self.store[owner]:
                    self._answer_get(owner, p, wrid)
                else:  # more waiters than elements cannot happen (unique pos)
                    self.pending_get[owner].setdefault(p, []).append(wrid)

    def _drain_pops(self, owner: int) -> None:
        """Stack: serve pending pops whose element (max ticket <= t') is here."""
        out = []
        for (p, t, rid) in self.pending_pop[owner]:
            slot: Dict[int, int] = self.store[owner].get(p, {})  # type: ignore
            cand = [tk for tk in slot if tk <= t]
            if cand:
                tk = max(cand)
                elem = slot.pop(tk)
                req = self.requests[rid]
                self._send(req.node, ("elem", rid, elem), delay=1)
            else:
                out.append((p, t, rid))
        self.pending_pop[owner] = out

    # ----------------------------------------------------------- schedulers --
    def run_rounds(self, n_rounds: int, inject_fn=None, drain: bool = True,
                   max_extra: int = 200_000) -> None:
        """Synchronous model: each round = deliver all due messages, fire
        TIMEOUT at every active node, optionally inject new requests."""
        for _ in range(n_rounds):
            self.now += 1
            if inject_fn is not None:
                inject_fn(self, self.now)
            self._deliver_due()
            self._fire_timeouts()
        if drain:
            # NOTE: empty batch waves circulate forever (that is the protocol's
            # steady state) so we drain on *request* completion, not the heap.
            extra = 0
            while self._any_ready() and extra < max_extra:
                self.now += 1
                extra += 1
                self._deliver_due()
                self._fire_timeouts()
            assert not self._any_ready(), "drain exceeded max_extra rounds"

    def _deliver_due(self) -> None:
        while self.msgs_heap and self.msgs_heap[0][0] <= self.now:
            _, _, dst, msg = heapq.heappop(self.msgs_heap)
            self.handle(dst, msg)

    def _fire_timeouts(self) -> None:
        for nid in self.ring.node_ids():
            self.timeout(nid)

    def _any_ready(self) -> bool:
        return any(not r.done for r in self.requests)

    def run_async(self, max_steps: int = 2_000_000,
                  timeout_prob: float = 0.5) -> bool:
        """Adversarial asynchronous scheduler: at each step either deliver a
        uniformly random in-flight message (arbitrary reordering) or fire
        TIMEOUT at a random node.  Returns True when all requests finished."""
        rng = self.rng
        for _ in range(max_steps):
            self.now += 1
            if not self._any_ready():
                return True
            pend = len(self.msgs_heap)
            nids = self.ring.node_ids()
            if pend > 0 and (rng.random() > timeout_prob
                             or pend > 4 * len(nids)):
                k = int(rng.integers(pend))
                self.msgs_heap[k], self.msgs_heap[-1] = (
                    self.msgs_heap[-1], self.msgs_heap[k])
                _, _, dst, msg = self.msgs_heap.pop()
                heapq.heapify(self.msgs_heap)
                self.handle(dst, msg)
            else:
                self.timeout(nids[int(rng.integers(len(nids)))])
        return not self._any_ready()

    # ------------------------------------------------------------- checks ---
    def check_dht_placement(self) -> None:
        """Every stored element AND parked pending request lives at its
        consistent-hashing owner.  (The seed version carried a dead guard —
        ``if not self.store[nid]`` inside the loop over that dict's own keys,
        which can never fire — and only checked the store.)"""
        for nid in range(len(self.store)):
            for p in self.store[nid]:
                owner = self.ring.owner_of_scalar(float(position_key(p)))
                assert owner == nid, (
                    f"element at pos {p} stored on {nid}, owner is {owner}")
            for p in self.pending_get[nid]:
                owner = self.ring.owner_of_scalar(float(position_key(p)))
                assert owner == nid, (
                    f"pending GET for pos {p} parked on {nid}, "
                    f"owner is {owner}")
            for (p, _t, _rid) in self.pending_pop[nid]:
                owner = self.ring.owner_of_scalar(float(position_key(p)))
                assert owner == nid, (
                    f"pending POP for pos {p} parked on {nid}, "
                    f"owner is {owner}")

    def queue_size(self) -> int:
        return self.anchor_state.size if self.mode == "queue" else self.anchor_state.last
