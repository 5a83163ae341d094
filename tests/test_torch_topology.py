"""The port's topology: LDB (Definition 2), the aggregation tree, the
dynamic ring and DHT fairness, on ``repro_torch.core``; and its hashing and
LDB against ``repro.core`` (splitmix64, hash01 and position_key bit for
bit, on edge and random values, as tensors and as numpy; labels, parents,
``owner_of`` and ``route_hops`` equal).  Integers and float64 bits: the
tolerance is zero."""
import numpy as np
import pytest
import torch

from repro.core import hashing as RH
from repro.core.ldb import LDB as RLDB
from repro.core.ring import DynamicRing as RRing

from repro_torch.core.hashing import hash01, position_key, splitmix64
from repro_torch.core.ldb import LDB, MIDDLE, RIGHT
from repro_torch.core.ring import DynamicRing

EDGES = np.array([0, 1, 2, 3, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                  2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1],
                 dtype=np.uint64)


def _values(kind):
    if kind == "edges":
        return EDGES
    return np.random.default_rng(7).integers(0, 2 ** 64 - 1, 4_096,
                                             dtype=np.uint64, endpoint=True)


def _t(x):
    """The uint64 bits as the int64 tensor the port computes in."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


@pytest.mark.parametrize("kind", ["edges", "random"])
def test_hashing_bit_identical_to_reference(kind):
    x = _values(kind)
    assert np.array_equal(splitmix64(_t(x)).numpy().view(np.uint64),
                          RH.splitmix64(x))
    assert np.array_equal(splitmix64(x), RH.splitmix64(x))
    for salt in (0, 1, 0xD47, 2 ** 63, 2 ** 64 - 1):
        assert np.array_equal(hash01(_t(x), salt).numpy(),
                              RH.hash01(x, salt)), salt
        assert np.array_equal(hash01(x, salt), RH.hash01(x, salt)), salt
    assert np.array_equal(position_key(_t(x)).numpy(), RH.position_key(x))
    for p in (0, 1, 17, 2 ** 31 - 1):      # the simulator's scalar path
        assert position_key(p) == RH.position_key(p)
        assert isinstance(position_key(p), np.floating)


def test_hashing_of_int32_tensors_sign_extends_as_numpy():
    x = np.array([-2 ** 31, -7, -1, 0, 5, 2 ** 31 - 1], np.int32)
    want = RH.hash01(x.astype(np.int64).astype(np.uint64), 3)
    assert np.array_equal(hash01(torch.from_numpy(x), 3).numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16, 33, 100, 257])
def test_ldb_tree_invariants(n):
    ldb = LDB.build(n, salt=n)
    ldb.check_tree()
    # every node has <= 2 children, right nodes have none
    assert (ldb.n_children <= 2).all()
    assert (ldb.n_children[ldb.kind == RIGHT] == 0).all()


@pytest.mark.parametrize("n", [4, 16, 64, 256, 1024, 4096])
def test_tree_height_logarithmic(n):
    """Corollary 6: aggregation tree height O(log n) w.h.p."""
    depths = [LDB.build(n, salt=s).depth.max() for s in range(3)]
    assert max(depths) <= 8 * np.log2(3 * n) + 8


def test_label_halving_structure():
    ldb = LDB.build(50, salt=1)
    # parent labels strictly decrease; middle's parent is exactly m/2
    for v in np.flatnonzero(ldb.kind == MIDDLE):
        p = ldb.parent[v]
        if p >= 0:
            assert abs(ldb.labels[p] - ldb.labels[v] / 2) < 1e-12


def test_ring_matches_static_ldb():
    """DynamicRing on static membership == LDB semantics."""
    n = 37
    ldb = LDB.build(n, salt=5)
    ring = DynamicRing.build(n, salt=5)
    ring.check_tree()
    assert ring.size == ldb.size
    ring_labels = [ring.labels[nid] for nid in ring.node_ids()]
    np.testing.assert_allclose(ring_labels, ldb.labels)
    keys = hash01(np.arange(200), salt=99)
    owners_ldb = ldb.owner_of(keys)
    for k, ow in zip(keys, owners_ldb.tolist()):
        nid = ring.owner_of_scalar(float(k))
        assert abs(ring.labels[nid] - ldb.labels[ow]) < 1e-12


def test_routing_hops_logarithmic():
    """Lemma 3: O(log n) routing."""
    for n in (16, 256, 1024):
        ldb = LDB.build(n, salt=2)
        rng = np.random.default_rng(0)
        src = rng.integers(ldb.size, size=200)
        keys = rng.random(200)
        hops = ldb.route_hops(torch.from_numpy(src), torch.from_numpy(keys))
        assert hops.dtype == torch.int64
        assert hops.double().mean() <= 4 * np.log2(3 * n) + 4
        # scalar path agrees
        for i in range(10):
            assert int(hops[i]) == ldb.route_hops_scalar(int(src[i]),
                                                         float(keys[i]))


def test_consistent_hashing_fair():
    """Lemma 4 (fairness): keys spread evenly over nodes."""
    ldb = LDB.build(64, salt=3)
    keys = position_key(torch.arange(20000))
    counts = torch.bincount(ldb.owner_of(keys), minlength=ldb.size)
    # expectation ~104 per node; no node should be grossly overloaded
    assert int(counts.max()) < 12 * keys.numel() / ldb.size
    assert int(counts.sum()) == keys.numel()


def test_owner_interval_semantics():
    ldb = LDB.build(10, salt=7)
    # owner of exactly a node label is that node
    for i in (0, 5, 17):
        assert int(ldb.owner_of(torch.tensor([ldb.labels[i]]))[0]) == i
    # key below the minimum wraps to the max node
    assert int(ldb.owner_of(torch.tensor([ldb.labels[0] / 2]))[0]) \
        == ldb.size - 1


# ------------------------------------------- against the reference --------
@pytest.mark.parametrize("n,salt", [(1, 0), (5, 7), (64, 3), (300, 11)])
def test_ldb_equals_reference(n, salt):
    ldb, ref = LDB.build(n, salt=salt), RLDB.build(n, salt=salt)
    for f in ("labels", "kind", "proc", "co", "parent", "children",
              "n_children", "depth"):
        assert np.array_equal(getattr(ldb, f), getattr(ref, f)), f
    assert ldb.anchor == ref.anchor
    rng = np.random.default_rng(n)
    keys = np.concatenate([rng.random(500), ldb.labels,
                           [0.0, ldb.labels[0] / 2, np.nextafter(1.0, 0)]])
    src = rng.integers(ldb.size, size=keys.size)
    assert np.array_equal(ldb.owner_of(torch.from_numpy(keys)).numpy(),
                          ref.owner_of(keys))
    assert np.array_equal(
        ldb.route_hops(torch.from_numpy(src), torch.from_numpy(keys)).numpy(),
        ref.route_hops(src, keys))
    for i in range(20):
        assert ldb.owner_of_scalar(float(keys[i])) == \
            ref.owner_of_scalar(float(keys[i]))
        assert ldb.route_hops_scalar(int(src[i]), float(keys[i])) == \
            ref.route_hops_scalar(int(src[i]), float(keys[i]))


def test_dynamic_ring_equals_reference_through_membership():
    ring, ref = DynamicRing.build(12, salt=4), RRing.build(12, salt=4)
    rng = np.random.default_rng(4)
    for step in range(6):
        trio = ring.add_process(12 + step, activate=False)
        assert trio == ref.add_process(12 + step, activate=False)
        for nid in trio[: 1 + step % 3]:
            ring.activate(nid)
            ref.activate(nid)
        gone = int(rng.choice(ring.node_ids()))
        if gone != ring.anchor:
            ring.deactivate(gone)
            ref.deactivate(gone)
        ring.check_tree()
        assert ring.labels == ref.labels and ring.node_ids() == ref.node_ids()
        assert ring.anchor == ref.anchor
        for nid in ring.node_ids():
            assert ring.parent(nid) == ref.parent(nid)
            assert ring.children(nid) == ref.children(nid)
            assert ring.depth(nid) == ref.depth(nid)
        for key in rng.random(50):
            assert ring.owner_of_scalar(key) == ref.owner_of_scalar(key)
            src = int(rng.choice(ring.node_ids()))
            assert ring.route_hops_scalar(src, key) == \
                ref.route_hops_scalar(src, key)
