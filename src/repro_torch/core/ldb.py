"""Linearized De Bruijn network (paper Definition 2) + aggregation tree.

Each process ``v`` emulates three virtual nodes: left ``l(v)=m/2``, middle
``m(v)=hash01(v.id)`` and right ``r(v)=(m+1)/2``.  Virtual nodes are arranged
on a sorted cycle; linear edges connect consecutive labels, virtual edges
connect co-located nodes.  The aggregation tree (Sec. III-B) is derived
purely from local information:

  parent(middle) = l(v); parent(left) = pred; parent(right) = m(v)

so every parent hop strictly decreases the label and the global minimum (the
*anchor*) is the root.  Routing (Lemma 3) follows the continuous-discrete
De Bruijn rule ``z -> (z + b)/2`` which this class simulates hop-by-hop,
vectorized over many concurrent messages.

Counterpart of ``repro/core/ldb.py``.  Construction and the scalar fast
paths are the reference's numpy and plain Python, so labels carry its
float64 bits; the vector forms :meth:`LDB.owner_of` and
:meth:`LDB.route_hops` take float64 key tensors (or arrays) and return
int64 tensors on the keys' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .hashing import hash01

LEFT, MIDDLE, RIGHT = 0, 1, 2


@dataclass
class LDB:
    """Static LDB instance over ``n`` processes (ids 0..n-1 by default)."""

    n: int                      # number of processes
    labels: np.ndarray          # [3n] label of virtual node, sorted ascending
    kind: np.ndarray            # [3n] LEFT/MIDDLE/RIGHT
    proc: np.ndarray            # [3n] emulating process id
    co: np.ndarray              # [3n, 3] sorted-index of (l, m, r) of same proc
    parent: np.ndarray          # [3n] sorted-index of tree parent, -1 at anchor
    children: np.ndarray        # [3n, 2] sorted-indices, -1 padded
    n_children: np.ndarray      # [3n]
    anchor: int                 # sorted index of the leftmost node
    depth: np.ndarray           # [3n] distance to anchor along parent edges

    @property
    def size(self) -> int:
        return 3 * self.n

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(n: int, proc_ids: Optional[np.ndarray] = None, salt: int = 0) -> "LDB":
        if n < 1:
            raise ValueError("need at least one process")
        ids = np.arange(n, dtype=np.uint64) if proc_ids is None else np.asarray(proc_ids, np.uint64)
        m = hash01(ids, salt=salt)
        # Perturb ties deterministically (labels must be unique).
        order = np.argsort(m, kind="stable")
        m_sorted = m[order]
        dup = np.concatenate([[False], np.diff(m_sorted) == 0])
        if dup.any():
            m_sorted = m_sorted + np.cumsum(dup) * 1e-15
            m[order] = m_sorted
        labels = np.concatenate([m / 2.0, m, (m + 1.0) / 2.0])
        kinds = np.concatenate([
            np.full(n, LEFT), np.full(n, MIDDLE), np.full(n, RIGHT)
        ]).astype(np.int8)
        procs = np.concatenate([np.arange(n)] * 3).astype(np.int64)
        srt = np.argsort(labels, kind="stable")
        labels, kinds, procs = labels[srt], kinds[srt], procs[srt]
        N = 3 * n
        # position of each original virtual node in the sorted order
        pos_of_orig = np.empty(N, dtype=np.int64)
        pos_of_orig[srt] = np.arange(N)
        co = np.stack([
            pos_of_orig[0 * n + np.arange(n)],   # l(v)
            pos_of_orig[1 * n + np.arange(n)],   # m(v)
            pos_of_orig[2 * n + np.arange(n)],   # r(v)
        ], axis=1)  # [n,3] by process id
        co_by_node = co[procs]  # [N,3]

        idx = np.arange(N)
        pred = (idx - 1) % N
        # parent rule (Sec. III-B)
        parent = np.where(
            kinds == MIDDLE, co_by_node[:, 0],
            np.where(kinds == LEFT, pred, co_by_node[:, 1]),
        ).astype(np.int64)
        anchor = 0  # sorted order => index 0 is the leftmost node
        parent[anchor] = -1
        # children: derived (and must mirror the parent rule exactly)
        children = np.full((N, 2), -1, dtype=np.int64)
        nch = np.zeros(N, dtype=np.int64)
        for v in range(N):
            p = parent[v]
            if p >= 0:
                children[p, nch[p]] = v
                nch[p] += 1
        # depth by pointer chasing in waves (labels strictly decrease => acyclic)
        depth = np.full(N, -1, dtype=np.int64)
        depth[anchor] = 0
        frontier = [anchor]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for v in frontier:
                for c in children[v]:
                    if c >= 0:
                        depth[c] = d
                        nxt.append(int(c))
            frontier = nxt
        assert (depth >= 0).all(), "aggregation tree must span all nodes"
        return LDB(n=n, labels=labels, kind=kinds, proc=procs, co=co,
                   parent=parent, children=children, n_children=nch,
                   anchor=anchor, depth=depth)

    # -- DHT ownership ------------------------------------------------------
    def owner_of(self, keys) -> torch.Tensor:
        """Sorted-index of the node v with v <= k < succ(v) (consistent hashing)."""
        keys = torch.as_tensor(keys, dtype=torch.float64)
        labels = torch.as_tensor(self.labels, device=keys.device)
        j = torch.searchsorted(labels, keys, right=True) - 1
        return torch.where(j < 0, self.size - 1, j)  # wrap: pred of min = max node

    # -- De Bruijn routing (Lemma 3), vectorized ----------------------------
    def route_hops(self, src, keys) -> torch.Tensor:
        """Number of LDB hops for each message from node ``src[i]`` to the
        owner of ``keys[i]``: simulates the continuous-discrete De Bruijn
        descent ``z -> (z+b)/2`` (one virtual hop + O(1) expected linear hops
        per bit) followed by the final linear walk.  Returns int64 hops on
        the keys' device.
        """
        keys = torch.as_tensor(keys, dtype=torch.float64)
        src = torch.as_tensor(src, dtype=torch.int64, device=keys.device)
        nbits = max(1, int(np.ceil(np.log2(max(2, self.size)))))
        cur = torch.as_tensor(self.labels, device=keys.device)[src]
        # extract target bits: keys = 0.b1 b2 b3 ...
        t = keys.clone()
        bits = []
        for _ in range(nbits):
            t = t * 2.0
            b = torch.floor(t)
            bits.append(b)
            t = t - b
        for i in range(nbits - 1, -1, -1):
            # De Bruijn hop toward prefix of target: z -> (z + b_i)/2; one
            # virtual hop + expected O(1) linear hops to snap to the node
            # nearest the continuous point (distance ~ spacing of labels)
            cur = (cur + bits[i]) / 2.0
        snapped = self.owner_of(cur)
        # final linear walk from snapped node to the key owner
        dist = (snapped - self.owner_of(keys)).abs()
        dist = torch.minimum(dist, self.size - dist)  # cycle distance
        return nbits + dist

    # -- scalar fast paths (hot in the event simulator) ----------------------
    def owner_of_scalar(self, key: float) -> int:
        j = int(np.searchsorted(self.labels, key, side="right")) - 1
        return self.size - 1 if j < 0 else j

    def route_hops_scalar(self, src: int, key: float) -> int:
        """Scalar version of :meth:`route_hops` (pure python, ~10x faster
        than the vectorized path for single messages)."""
        nbits = max(1, int(np.ceil(np.log2(max(2, self.size)))))
        cur = float(self.labels[src])
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
        dist = abs(snapped - tgt)
        dist = min(dist, self.size - dist)
        return nbits + dist

    # -- invariant checks (used by tests) -----------------------------------
    def check_tree(self) -> None:
        N = self.size
        assert self.parent[self.anchor] == -1
        par = self.parent
        lab = self.labels
        mask = np.arange(N) != self.anchor
        assert (lab[par[mask]] < lab[mask]).all(), "parent labels must decrease"
        # children lists mirror parents
        for v in range(N):
            for c in self.children[v]:
                if c >= 0:
                    assert par[c] == v
        assert int(self.n_children.sum()) == N - 1
