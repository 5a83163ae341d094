"""Dynamic LDB ring with stable node ids (supports JOIN/LEAVE, paper Sec. IV).

Counterpart of ``repro/core/ring.py``: plain Python over the scalar
(numpy) forms of :mod:`.hashing`, as the simulator calls it once per
message.  The static :class:`~repro_torch.core.ldb.LDB` uses sorted
indices; membership
changes would invalidate them.  Here every virtual node has a *stable id*;
the sorted cycle, aggregation-tree parent/children and DHT ownership are
recomputed against the current active set (cached, invalidated on change).
Semantics (parent/children rules, ownership, De Bruijn routing) are identical
to ``LDB`` — ``tests/test_torch_topology.py`` cross-checks them on static
membership.
"""
from __future__ import annotations

from bisect import bisect_right, insort
from typing import Dict, List, Tuple

import numpy as np

from .hashing import hash01

LEFT, MIDDLE, RIGHT = 0, 1, 2


class DynamicRing:
    def __init__(self, salt: int = 0):
        self.salt = salt
        self.labels: List[float] = []   # by node id
        self.kind: List[int] = []
        self.proc: List[int] = []
        self.active: List[bool] = []
        self.co: List[Tuple[int, int, int]] = []  # (l,m,r) ids per node id
        self._sorted: List[Tuple[float, int]] = []  # active (label, id), sorted
        self._parent: Dict[int, int] = {}
        self._children: Dict[int, List[int]] = {}
        self._dirty = True

    # ------------------------------------------------------------ build ----
    @staticmethod
    def build(n: int, salt: int = 0) -> "DynamicRing":
        r = DynamicRing(salt=salt)
        for pid in range(n):
            r.add_process(pid, activate=True)
        return r

    def _label_of_proc(self, pid: int) -> float:
        m = float(hash01(np.uint64(pid), salt=self.salt))
        # nudge collisions deterministically (labels must be unique)
        while any(abs(m - l) < 1e-15 for l in self.labels):
            m = float(np.nextafter(m, 1.0))
        return m

    def add_process(self, pid: int, activate: bool) -> Tuple[int, int, int]:
        """Create the three virtual nodes l(v), m(v), r(v) for a process."""
        m = self._label_of_proc(pid)
        ids = []
        for kind, lab in ((LEFT, m / 2.0), (MIDDLE, m), (RIGHT, (m + 1.0) / 2.0)):
            nid = len(self.labels)
            self.labels.append(lab)
            self.kind.append(kind)
            self.proc.append(pid)
            self.active.append(False)
            self.co.append((-1, -1, -1))
            ids.append(nid)
        trio = (ids[0], ids[1], ids[2])
        for nid in ids:
            self.co[nid] = trio
        if activate:
            for nid in ids:
                self.activate(nid)
        return trio

    def activate(self, nid: int) -> None:
        if not self.active[nid]:
            self.active[nid] = True
            insort(self._sorted, (self.labels[nid], nid))
            self._dirty = True

    def deactivate(self, nid: int) -> None:
        if self.active[nid]:
            self.active[nid] = False
            self._sorted.remove((self.labels[nid], nid))
            self._dirty = True

    # -------------------------------------------------------- topology -----
    @property
    def size(self) -> int:
        return len(self._sorted)

    def node_ids(self) -> List[int]:
        return [nid for _, nid in self._sorted]

    def _rebuild(self) -> None:
        if not self._dirty:
            return
        self._parent.clear()
        self._children.clear()
        order = self._sorted
        N = len(order)
        pos = {nid: i for i, (_, nid) in enumerate(order)}
        for i, (_, nid) in enumerate(order):
            k = self.kind[nid]
            l_id, m_id, _r_id = self.co[nid]
            if k == MIDDLE and self.active[l_id]:
                p = l_id
            elif k == RIGHT and self.active[m_id]:
                p = m_id
            else:  # LEFT, or co-node inactive: fall back to pred (label decreases)
                p = order[(i - 1) % N][1] if i > 0 else -1
            if i == 0:
                p = -1  # the leftmost active node is the anchor
            self._parent[nid] = p
            if p >= 0:
                self._children.setdefault(p, []).append(nid)
        self._pos = pos
        self._dirty = False

    @property
    def anchor(self) -> int:
        self._rebuild()
        return self._sorted[0][1]

    def parent(self, nid: int) -> int:
        self._rebuild()
        return self._parent[nid]

    def children(self, nid: int) -> List[int]:
        self._rebuild()
        return self._children.get(nid, [])

    def pred(self, nid: int) -> int:
        self._rebuild()
        i = self._pos[nid]
        return self._sorted[(i - 1) % self.size][1]

    def succ(self, nid: int) -> int:
        self._rebuild()
        i = self._pos[nid]
        return self._sorted[(i + 1) % self.size][1]

    def depth(self, nid: int) -> int:
        self._rebuild()
        d = 0
        while self._parent[nid] >= 0:
            nid = self._parent[nid]
            d += 1
        return d

    def max_depth(self) -> int:
        return max(self.depth(nid) for _, nid in self._sorted)

    # ---------------------------------------------------------- routing ----
    def owner_of_scalar(self, key: float) -> int:
        """Active node v with v <= key < succ(v) (consistent hashing)."""
        j = bisect_right(self._sorted, (key, float("inf"))) - 1
        return self._sorted[j][1] if j >= 0 else self._sorted[-1][1]

    def route_hops_scalar(self, src: int, key: float) -> int:
        """Continuous-discrete De Bruijn descent (Lemma 3), hop count."""
        N = max(2, self.size)
        nbits = max(1, int(np.ceil(np.log2(N))))
        cur = self.labels[src]
        t = float(key)
        bits = []
        for _ in range(nbits):
            t *= 2.0
            b = int(t)
            bits.append(b)
            t -= b
        for i in range(nbits - 1, -1, -1):
            cur = (cur + bits[i]) / 2.0
        snapped = self.owner_of_scalar(cur)
        tgt = self.owner_of_scalar(key)
        self._rebuild()
        a, b2 = self._pos[snapped], self._pos[tgt]
        dist = abs(a - b2)
        dist = min(dist, self.size - dist)
        return nbits + dist

    # ------------------------------------------------------------ checks ---
    def check_tree(self) -> None:
        self._rebuild()
        anchor = self.anchor
        for _, nid in self._sorted:
            p = self._parent[nid]
            if nid == anchor:
                assert p == -1
            else:
                assert p >= 0 and self.labels[p] < self.labels[nid]
        n_edges = sum(len(c) for c in self._children.values())
        assert n_edges == self.size - 1
