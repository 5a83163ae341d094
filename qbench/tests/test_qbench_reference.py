"""The plain models against the port, run on the CPU at a small size.

8 shards x 64 ops, bursts of 4 waves, a LEAVE of two shards and a JOIN of
two, the queue filled and drained to ⊥: every output of every burst and
the size after each step must be the model's.
"""
import pytest
import torch

from qbench.reference.fifo import FifoModel, wrap32
from qbench.reference.payload import words
from qbench.reference.priority import PriorityModel
from repro_torch.dqueue import ElasticDeviceQueue, ElasticDevicePriorityQueue

N, L, CAP, K, W = 8, 64, 512, 4, 4
ENQ_SHARES = (0.9, 0.6, 0.5, 0.5, 0.3, 0.2, 0.1, 0.05)


def _bursts(q, seed, tiers):
    """Drive ``q`` through the shares above, shrinking before the 5th
    burst and growing before the 7th; yield each burst's inputs and
    outputs."""
    g = torch.Generator().manual_seed(seed)
    nid = 0
    for b, p in enumerate(ENQ_SHARES):
        if b == 4:
            q.shrink([1, 5])
        if b == 6:
            q.grow(2)
        n = q.n_shards * L
        e = torch.rand(K, n, generator=g) < p
        v = torch.rand(K, n, generator=g) < 0.9
        ids = nid + torch.arange(K * n).view(K, n)
        nid += K * n
        if tiers:
            prio = torch.multinomial(torch.tensor([.4, .3, .2, .1]), K * n,
                                     replacement=True, generator=g)
            prio = prio.view(K, n).to(torch.int32)
            out = q.run_waves(e, v, prio, words(ids, W))
            yield e, v, prio, ids, out
        else:
            yield e, v, None, ids, q.run_waves(e, v, words(ids, W))


def _vals(a):
    v = torch.zeros(a["deq_ok"].shape + (W,), dtype=torch.int32)
    v[a["deq_ok"]] = words(a["deq_ids"][a["deq_ok"]], W)
    return v


@pytest.mark.parametrize("seed", [0, 1])
def test_fifo_model_matches_the_port(seed):
    q = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                           device="cpu")
    m = FifoModel(N * CAP, K * N * L, "cpu")
    bottoms = 0
    for e, v, _, ids, (pos, matched, dv, dok, ovf) in _bursts(q, seed, False):
        a = m.burst(e, v, ids, q.n_shards * CAP)
        assert torch.equal(a["pos"], pos)
        assert torch.equal(a["matched"], matched)
        assert torch.equal(a["deq_ok"], dok)
        assert torch.equal(_vals(a), dv)
        assert torch.equal(a["overflow"], ovf)
        assert m.size == q.size
        bottoms += int((v & ~e & ~matched).sum())
    assert bottoms > 0 and m.size == 0      # drained through to ⊥


@pytest.mark.parametrize("relaxation", [0, 1, 2])
def test_priority_model_matches_the_port(relaxation):
    q = ElasticDevicePriorityQueue(N, n_prios=4, relaxation=relaxation,
                                   cap=CAP, payload_width=W,
                                   ops_per_shard=L, device="cpu")
    m = PriorityModel(4, relaxation, N * CAP, K * N * L, "cpu")
    n_rel = 0
    for e, v, prio, ids, out in _bursts(q, 7, True):
        tier, pos, matched, dv, dok, ovf, nr = out
        a = m.burst(e, v, prio, ids, q.n_shards, q.n_shards * CAP)
        for key, got in (("tier", tier), ("pos", pos), ("matched", matched),
                         ("deq_ok", dok), ("overflow", ovf),
                         ("n_relaxed", nr)):
            assert torch.equal(a[key].to(got.dtype), got), key
        assert torch.equal(_vals(a), dv)
        assert m.sizes == q.sizes
        n_rel += int(nr.sum())
    assert (n_rel > 0) == (relaxation > 0)


def test_wrap32_wraps_as_int32():
    x = torch.tensor([0, 2 ** 31 - 1, 2 ** 31, -1, 2 ** 32 + 5])
    assert wrap32(x).tolist() == [0, 2 ** 31 - 1, -2 ** 31, -1, 5]


def test_payload_words_are_distinct_and_carry_the_id():
    ids = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1])
    w = words(ids, 6)
    assert w.shape == (4, 6) and w.dtype == torch.int32
    assert torch.equal(torch.remainder(w[:, 0].long(), 1 << 32), ids)
    for j in range(6):
        assert len(set(w[:, j].tolist())) == 4
