"""Compact waves on the port's four elastic structures, mirroring the
reference's property test (``tests/test_compact_waves.py``): random op
streams cut into single-wave chunks, each chunk riding a random width of
the bucket ladder that fits it, with JOIN/LEAVE between chunks, on
``device="cpu"``.  Every per-op output and the final state must be equal,
bit for bit, to the same chunks ridden at the full width L (the store's
junk slot excluded: padding writes scratch there), and op by op equal to
a sequential replay (FIFO, LIFO) or to the port's host oracles
(``PriorityOracle``, ``SeapOracle``), directory included."""
import numpy as np
import torch
from _hyp import given, settings, strategies as st

from repro_torch.core.priority import DEQ as PDEQ, ENQ as PENQ, PriorityOracle
from repro_torch.core.seap import DEQ as SDEQ, ENQ as SENQ, SeapOracle
from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                ElasticDeviceQueue, ElasticDeviceSeapQueue,
                                ElasticDeviceStack)

L, B_, SPLIT_OCC = 4, 4, 6


def _run_device(elastic, case, codes=None, compact=False):
    """Drive the chunk schedule; ``compact`` rides mixed ladder widths."""
    wrng = np.random.default_rng(case["width_seed"])
    ops, outs, start = case["ops"], [], 0
    for ci, m in enumerate(case["chunks"]):
        chunk = ops[start:start + m]
        if compact:
            ladder = [w for w in elastic.bucket_widths()
                      if elastic.n_shards * w >= m]
            w = int(wrng.choice(ladder))
            assert w >= elastic.pick_width(m)
        else:
            w = elastic.L
        n = elastic.n_shards * w
        E, V = np.zeros(n, bool), np.zeros(n, bool)
        PR, PW = np.zeros(n, np.int32), np.zeros((n, 2), np.int32)
        E[:m], V[:m] = chunk, True
        PW[:m, 0] = np.arange(start, start + m)
        if codes is not None:
            PR[:m] = codes[start:start + m]
            tier, pos, mt, dv, dok, _ovf, _aux = elastic.step(E, V, PR, PW)
        else:
            pos, mt, dv, dok, _ovf = elastic.step(E, V, PW)
            tier = pos
        pos, mt, tier, dv, dok = (x.numpy()[:m]
                                  for x in (pos, mt, tier, dv, dok))
        for j, op in enumerate(chunk):
            res = int(dv[j, 0]) if (not op) and mt[j] and dok[j] else None
            outs.append((int(pos[j]), bool(mt[j]), res, int(tier[j])))
        if ci in case["schedule"]:
            kind, arg = case["schedule"][ci]
            (elastic.grow if kind == "grow" else elastic.shrink)(arg)
        start += m
    return outs


def _assert_twin(make, case, codes=None):
    """The compact run == the full-width run, bit for bit (ops AND state)."""
    a, b = make(), make()
    out_a = _run_device(a, case, codes, compact=True)
    assert out_a == _run_device(b, case, codes, compact=False), a._kind
    sa, sb = a._state_dict(), b._state_dict()
    for k in sa:
        xa, xb = sa[k], sb[k]
        if xa.dim() >= 2:        # [shards, slots + junk, ...]: drop the junk
            xa, xb = xa[:, :-1], xb[:, :-1]
        assert torch.equal(xa, xb), (a._kind, k)
    return a, out_a


def _elastic(cls, **kw):
    return lambda: cls(4, cap=32, payload_width=2, ops_per_shard=L,
                       pool_size=8, device="cpu", **kw)


def _case(ops, seed, n_events):
    rng = np.random.default_rng(seed)
    n_prios = int(rng.integers(2, 4))
    # chunks that always fit ONE wave at the minimum membership the
    # schedule can reach (2 shards x L = 4)
    chunks, left = [], len(ops)
    while left:
        m = int(rng.integers(1, min(8, left) + 1))
        chunks.append(m)
        left -= m
    schedule, shards = {}, 4
    for idx in sorted(rng.choice(np.arange(len(chunks)),
                                 size=min(n_events, len(chunks)),
                                 replace=False).tolist()):
        if rng.random() < 0.5 and shards <= 6:
            k = int(rng.integers(1, min(2, 8 - shards) + 1))
            schedule[int(idx)] = ("grow", k)
            shards += k
        elif shards >= 3:
            m = int(rng.integers(1, min(2, shards - 2) + 1))
            ids = sorted(rng.choice(np.arange(shards), size=m,
                                    replace=False).tolist())
            schedule[int(idx)] = ("shrink", [int(i) for i in ids])
            shards -= m
    return {"ops": [bool(o) for o in ops], "chunks": chunks,
            "schedule": schedule, "n_prios": n_prios,
            "prios": [int(p) for p in rng.integers(0, n_prios, len(ops))],
            "keys": [int(k) for k in rng.integers(-1000, 1000, len(ops))],
            "width_seed": int(rng.integers(2 ** 31))}


@given(st.lists(st.booleans(), min_size=16, max_size=40),
       st.integers(0, 2 ** 31 - 1), st.integers(0, 2))
@settings(max_examples=25, deadline=None)
def test_mixed_bucket_widths_match_oracles_and_full_width(ops, seed,
                                                          n_events):
    case = _case(ops, seed, n_events)
    ops = case["ops"]

    # FIFO / LIFO: twin parity and a sequential replay of the op stream
    # (positions are wave-partition independent for both orders)
    q, out = _assert_twin(_elastic(ElasticDeviceQueue), case)
    first, last, vals, ref = 0, -1, {}, []
    for j, op in enumerate(ops):
        if op:
            last += 1
            vals[last] = j
            ref.append((last, True, None))
        elif first <= last:
            ref.append((first, True, vals[first]))
            first += 1
        else:
            ref.append((-1, False, None))
    assert [d[:3] for d in out] == ref, "queue replay"
    assert q.size == last - first + 1

    s, out = _assert_twin(_elastic(ElasticDeviceStack, slot_depth=8), case)
    depth, stk, ref = 0, [], []
    for j, op in enumerate(ops):
        if op:
            depth += 1
            stk.append(j)
            ref.append((depth, True, None))
        elif depth >= 1:
            ref.append((depth, True, stk.pop()))
            depth -= 1
        else:
            ref.append((-1, False, None))
    assert [d[:3] for d in out] == ref, "stack replay"
    assert s.size == depth

    # priority: twin parity and op-by-op parity with the port's oracle
    P_ = case["n_prios"]
    pq, dev = _assert_twin(_elastic(ElasticDevicePriorityQueue, n_prios=P_),
                           case, codes=case["prios"])
    oracle, recs, start, shards = PriorityOracle(P_), [], 0, 4
    for ci, m in enumerate(case["chunks"]):
        recs.extend(oracle.wave(
            [(PENQ, case["prios"][j], j, 0) if ops[j] else (PDEQ, 0, None, 0)
             for j in range(start, start + m)], n_shards=shards))
        if ci in case["schedule"]:
            kind, arg = case["schedule"][ci]
            shards += arg if kind == "grow" else -len(arg)
        start += m
    _check_records(dev, recs, "tier")
    assert pq.sizes == oracle.sizes

    # Seap: twin parity and op-by-op parity with the port's oracle
    sq, dev = _assert_twin(_elastic(ElasticDeviceSeapQueue, n_buckets=B_,
                                    split_occupancy=SPLIT_OCC),
                           case, codes=case["keys"])
    oracle, recs, start = SeapOracle(B_, split_occupancy=SPLIT_OCC), [], 0
    for m in case["chunks"]:
        recs.extend(oracle.wave(
            [(SENQ, case["keys"][j], j) if ops[j] else (SDEQ, 0, None)
             for j in range(start, start + m)]))
        start += m
    _check_records(dev, recs, "bucket")
    assert sq.sizes == oracle.sizes
    assert sq.directory() == oracle.directory()


def _check_records(dev, recs, tier_field):
    assert len(recs) == len(dev)
    for j, (d, r) in enumerate(zip(dev, recs)):
        assert d[1] == r.matched and d[0] == r.pos, j
        if r.matched:
            assert d[3] == getattr(r, tier_field), j
            if r.value is not None:
                assert d[2] == r.value, j
