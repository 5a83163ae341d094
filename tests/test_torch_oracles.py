"""The port's host oracles against the reference's: ``PriorityOracle``
(strict and relaxed, shard counts that change between waves as JOIN and
LEAVE do) and ``SeapOracle`` (cold and seeded directories, splits and
on-demand merges, keys at both int32 edges) on the same random wave
schedules.  Every op's record, the sizes and the directory must be
equal (integers: the tolerance is zero)."""
import dataclasses

import numpy as np
import pytest

from repro.core.priority import PriorityOracle as RefPriorityOracle
from repro.core.seap import SeapOracle as RefSeapOracle

from repro_torch.core.priority import DEQ, ENQ, PriorityOracle
from repro_torch.core.seap import (INT32_MAX, INT32_MIN, SeapOracle,
                                   check_seed_bounds)


def _same(recs, ref_recs):
    assert [dataclasses.astuple(r) for r in recs] == \
        [dataclasses.astuple(r) for r in ref_recs]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_prios,relax", [(1, 0), (4, 0), (4, 1), (7, 3)])
def test_priority_oracle_equals_reference(n_prios, relax, seed):
    rng = np.random.default_rng(seed * 31 + n_prios)
    port = PriorityOracle(n_prios, relaxation=relax)
    ref = RefPriorityOracle(n_prios, relaxation=relax)
    n_shards, n_relaxed = 4, 0
    for w in range(30):
        if w % 7 == 6:              # JOIN or LEAVE between waves
            n_shards = int(rng.integers(2, 9))
        n = int(rng.integers(1, 48))
        p_enq = (0.8, 0.5, 0.2)[w % 3]
        ops = []
        for i in range(n):
            shard = int(rng.integers(n_shards))
            r = rng.random()
            if r < 0.1:
                ops.append(None)
            elif r < 0.1 + 0.9 * p_enq:
                ops.append((ENQ, int(rng.integers(n_prios)),
                            int(rng.integers(1 << 20)), shard))
            else:
                ops.append((DEQ, 0, None, shard))
        recs = port.wave(ops, n_shards=n_shards)
        _same(recs, ref.wave(ops, n_shards=n_shards))
        n_relaxed += sum(r.relaxed for r in recs)
        assert port.sizes == ref.sizes and port.size == ref.size
        assert (port.firsts, port.lasts, port.store) == \
            (ref.firsts, ref.lasts, ref.store)
    assert (n_relaxed > 0) == (relax > 0)


def test_priority_oracle_rejects_out_of_range_tier():
    for cls in (PriorityOracle, RefPriorityOracle):
        with pytest.raises(ValueError):
            cls(2).wave([(ENQ, 2, 0, 0)])
        with pytest.raises(ValueError):
            cls(0)


def _keys(rng, n, edge):
    key = rng.integers(-1_000, 1_000, n)
    if edge:
        u = rng.random(n)
        key[u < 0.15] = INT32_MIN + rng.integers(0, 3, int((u < 0.15).sum()))
        key[u > 0.85] = INT32_MAX - rng.integers(0, 3, int((u > 0.85).sum()))
    return [int(k) for k in key]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("B,occ,seeds,edge", [
    (4, 6, None, False), (8, 4, [-500, 0, 500], False), (4, 3, None, True),
    (2, 2, None, True)])
def test_seap_oracle_equals_reference(B, occ, seeds, edge, seed):
    rng = np.random.default_rng(seed * 17 + B + occ)
    port = SeapOracle(B, split_occupancy=occ, seed_bounds=seeds)
    ref = RefSeapOracle(B, split_occupancy=occ, seed_bounds=seeds)
    for w in range(40):
        n = int(rng.integers(1, 24))
        p_enq = (0.8, 0.7, 0.3, 0.1)[(w // 5) % 4]
        keys = _keys(rng, n, edge)
        ops = [None if rng.random() < 0.1 else
               ((ENQ, keys[i], int(rng.integers(1 << 20)))
                if rng.random() < p_enq else (DEQ, 0, None))
               for i in range(n)]
        _same(port.wave(ops), ref.wave(ops))
        assert port.directory() == ref.directory()
        assert (port.sizes, port.n_active, port.key_lo, port.key_hi) == \
            (ref.sizes, ref.n_active, ref.key_lo, ref.key_hi)
    assert (port.n_splits, port.n_merges) == (ref.n_splits, ref.n_merges)
    assert port.n_splits > 0


def test_seap_oracle_merges_on_demand():
    """A full directory recycles its lowest-id empty bucket for a split:
    the same ids and boundaries as the reference."""
    port = SeapOracle(3, split_occupancy=2)
    ref = RefSeapOracle(3, split_occupancy=2)
    waves = [[(ENQ, k, k) for k in (0, 10, 20)],          # split
             [(ENQ, k, k) for k in (30, 40, 50)],         # split: full
             [(DEQ, 0, None)] * 5,                        # empties buckets
             [(ENQ, k, k) for k in (60, 61, 62)]]         # merge + split
    for ops in waves:
        _same(port.wave(ops), ref.wave(ops))
        assert port.directory() == ref.directory()
    assert port.n_merges == ref.n_merges > 0


def test_seed_bounds_validation_equals_reference():
    from repro.core.seap import check_seed_bounds as ref_check
    for bad in ([3, 1], [INT32_MIN], [1, 2, 3, 4]):
        for fn in (check_seed_bounds, ref_check):
            with pytest.raises(ValueError):
                fn(bad, 4)
    assert check_seed_bounds([-5, 9], 4) == ref_check([-5, 9], 4)
