"""The port's CUDA kernels and wave path on the card against their plain
versions on the CPU.

Every test here is marked ``gpu`` and skips itself where there is no CUDA
device (a CUDA kernel has no CPU mode).  This file imports no jax, so it
also runs where only PyTorch is installed: ``python -m pytest -m gpu
tests/test_torch_gpu.py``.  All outputs are integers: the tolerance is
zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.dqueue import (DevicePriorityQueue, DeviceQueue,
                                DeviceStack, ElasticDeviceQueue)
from repro_torch.kernels.hash_route import hash_route, hash_route_ref
from repro_torch.kernels.segscan import (queue_scan, queue_scan_ref,
                                         stack_scan, stack_scan_ref,
                                         tiered_queue_scan,
                                         tiered_queue_scan_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _i32(x, device="cpu"):
    return torch.tensor(x, dtype=torch.int32, device=device)


@pytest.mark.parametrize("n", [1, 1500, 65536, 1 << 20])
def test_queue_scan_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    for p_enq, p_valid in ((0.65, 1.0), (0.0, 1.0), (0.5, 0.8)):
        e = torch.from_numpy(rng.random(n) < p_enq)
        v = torch.from_numpy(rng.random(n) < p_valid)
        for f, l in ((0, -1), (1_000_000, 1_005_000)):
            before = queue_scan.launches
            got = queue_scan(e.to(cuda), v.to(cuda), _i32(f, cuda),
                             _i32(l, cuda))
            assert queue_scan.launches == before + 1
            for a, b in zip(got, queue_scan_ref(e, v, _i32(f), _i32(l))):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [1, 1500, 65536, 1 << 20])
def test_stack_scan_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    for p_push, p_valid in ((0.65, 1.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.8)):
        e = torch.from_numpy(rng.random(n) < p_push)
        v = torch.from_numpy(rng.random(n) < p_valid)
        for last, tick in ((0, 0), (1, 5), (1_000_000, 2 ** 31 - n - 2)):
            before = stack_scan.launches
            got = stack_scan(e.to(cuda), v.to(cuda), _i32(last, cuda),
                             _i32(tick, cuda))
            assert stack_scan.launches == before + 1
            for a, b in zip(got, stack_scan_ref(e, v, _i32(last),
                                                _i32(tick))):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [1, 1500, 65536, 1 << 20])
@pytest.mark.parametrize("n_tiers", [1, 4, 64])
def test_tiered_scan_kernel_matches_plain(cuda, n, n_tiers):
    rng = np.random.default_rng(n + n_tiers)
    tier = torch.from_numpy(rng.integers(-1, n_tiers + 1, n).astype(np.int32))
    firsts = torch.from_numpy(rng.integers(0, 9, n_tiers).astype(np.int32))
    lasts = firsts + torch.from_numpy(
        rng.integers(-1, 1000, n_tiers).astype(np.int32))
    lasts[0] = 2 ** 31 - 5                      # wraps like int32 sums
    for p_enq in (1.0, 0.0, 0.6):
        enq = torch.from_numpy(rng.random(n) < p_enq)
        before = tiered_queue_scan.launches
        got = tiered_queue_scan(enq.to(cuda), tier.to(cuda),
                                firsts.to(cuda), lasts.to(cuda), n_tiers)
        assert tiered_queue_scan.launches == before + 1
        for a, b in zip(got, tiered_queue_scan_ref(enq, tier, lasts)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_shards", [1, 48, 64])
def test_hash_route_kernel_matches_plain(cuda, n_shards):
    rng = np.random.default_rng(n_shards)
    pos = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 1 << 20,
                                        dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random(1 << 20) < 0.9)
    before = hash_route.launches
    got = hash_route(pos.to(cuda), valid.to(cuda), n_shards)
    assert hash_route.launches == before + 1
    for a, b in zip(got, hash_route_ref(pos, valid, n_shards)):
        assert torch.equal(a.cpu(), b)


def _waves(n_shards, L, W, K, seed):
    rng = np.random.default_rng(seed)
    nL = n_shards * L
    E = torch.from_numpy(rng.random((K, nL)) < 0.6)
    V = torch.from_numpy(rng.random((K, nL)) < 0.9)
    P = torch.from_numpy(rng.integers(0, 2 ** 31, (K, nL, W),
                                      dtype=np.int64).astype(np.int32))
    return E, V, P


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_queue_on_gpu_matches_cpu(cuda, pipelined):
    E, V, P = _waves(4, 8, 2, 6, seed=1)
    outs = []
    for dev in ("cpu", cuda):
        q = DeviceQueue(4, cap=16, payload_width=2, ops_per_shard=8,
                        pipelined=pipelined, device=dev)
        st, *o = q.run_waves(q.init_state(), E.to(dev), V.to(dev),
                             P.to(dev))
        outs.append([x.cpu() for x in o]
                    + [st.store_vals[:, :16].cpu(), st.store_full.cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_elastic_on_gpu_matches_cpu_through_join_and_leave(cuda):
    runs = []
    for dev in ("cpu", cuda):
        eq = ElasticDeviceQueue(4, cap=32, payload_width=2, ops_per_shard=4,
                                pool_size=8, device=dev)
        res = []
        for i, action in enumerate([None, ("grow", 2), None,
                                    ("shrink", [0, 2, 4]), None,
                                    ("grow", 2), None]):
            if action is None:
                E, V, P = _waves(eq.n_shards, 4, 2, 3, seed=i)
                res += [x.cpu() for x in eq.run_waves(E.to(dev), V.to(dev),
                                                      P.to(dev))]
            else:
                st = (eq.grow(action[1]) if action[0] == "grow"
                      else eq.shrink(action[1]))
                assert st["moved"] == eq.size
                res.append(torch.tensor(st["hash_balance"]["counts"]))
        runs.append(res + [eq.state.store_vals[:, :32].cpu(),
                           eq.state.store_full.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_stack_64_shards_on_gpu_matches_cpu(cuda, pipelined):
    E, V, P = _waves(64, 16, 2, 4, seed=2)
    outs = []
    for dev in ("cpu", cuda):
        s = DeviceStack(64, cap=64, payload_width=2, ops_per_shard=16,
                        slot_depth=4, pipelined=pipelined, device=dev)
        before = stack_scan.launches
        st, *o = s.run_waves(s.init_state(), E.to(dev), V.to(dev),
                             P.to(dev))
        if dev != "cpu":
            assert stack_scan.launches == before + 4
        outs.append([x.cpu() for x in o]
                    + [st.ticks[:, :64].cpu(), st.vals[:, :64].cpu(),
                       st.last.cpu(), st.ticket.cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_priority_queue_64_shards_on_gpu_matches_cpu(cuda, pipelined):
    E, V, P = _waves(64, 16, 2, 4, seed=3)
    rng = np.random.default_rng(3)
    PR = torch.from_numpy(rng.choice(4, E.shape, p=[0.1, 0.2, 0.3, 0.4])
                          .astype(np.int32))
    outs = []
    for dev in ("cpu", cuda):
        q = DevicePriorityQueue(64, n_prios=4, cap=64, payload_width=2,
                                ops_per_shard=16, pipelined=pipelined,
                                device=dev)
        before = tiered_queue_scan.launches
        st, *o = q.run_waves(q.init_state(), E.to(dev), V.to(dev),
                             PR.to(dev), P.to(dev))
        if dev != "cpu":
            assert tiered_queue_scan.launches == before + 4
        outs.append([x.cpu() for x in o]
                    + [st.store_vals[:, :256].cpu(), st.store_full.cpu(),
                       st.firsts.cpu(), st.lasts.cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
