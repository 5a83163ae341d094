"""The port's CUDA kernels and wave path on the card against their plain
versions on the CPU.

Every test here is marked ``gpu`` and skips itself where there is no CUDA
device (a CUDA kernel has no CPU mode).  This file imports no jax, so it
also runs where only PyTorch is installed: ``python -m pytest -m gpu
tests/test_torch_gpu.py``.  The queue kernels' outputs are integers:
their tolerance is zero.  The attention and SSD kernels compute in f32 in
another summation order than their plain versions on the same device
tensors; each test states its tolerance.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.dqueue import (DevicePriorityQueue, DeviceQueue,
                                DeviceSeapQueue, DeviceStack,
                                ElasticDevicePriorityQueue,
                                ElasticDeviceQueue, ElasticDeviceSeapQueue)
from repro_torch.kernels.flash_attention import (attention_backward_chunked,
                                                 attention_chunked,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import (bwd_tc_route,
                                                        tc_route)
from repro_torch.kernels.hash_route import hash_route, hash_route_ref
from repro_torch.kernels.hash_route.kernel import (
    MAX_SHARDS as HASH_MAX_SHARDS, hash_route_kernel)
from repro_torch.kernels.relaxed import (relaxed_deletemin,
                                         relaxed_deletemin_ref,
                                         relaxed_walk_model)
from repro_torch.kernels.relaxed.kernel import (MAX_TIERS, STATS,
                                                relaxed_deletemin_kernel)
from repro_torch.kernels.segscan import (queue_scan, queue_scan_ref,
                                         stack_scan, stack_scan_ref,
                                         tiered_queue_scan,
                                         tiered_queue_scan_ref)
from repro_torch.kernels.segscan.kernel import TILE
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref, ssd_scan,
                                          ssd_scan_backward_ref)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_kernel

pytestmark = pytest.mark.gpu

# test_model_on_gpu_matches_cpu's tolerance on logits, per case, about
# twice the largest reading on an NVIDIA H100 80GB HBM3 at 700 W (the test
# prints them; run with -s): zamba2 0.0088, mamba2 0.0039, llama3 0.0042;
# at head dim 64 (the tensor-core flash route) zamba2 0.0068, llama3
# 0.0098; granite-moe-1b 0.0059, llava-next-34b 0.0059 and whisper-small
# 0.0078 (test_encdec_on_gpu_matches_cpu)
GPU_CPU_LOGIT_TOL = {"zamba2_1p2b": 0.02, "mamba2_130m": 0.01,
                     "llama3_8b": 0.01, "zamba2_1p2b-d64": 0.02,
                     "llama3_8b-d64": 0.02, "granite_moe_1b-d64": 0.012,
                     "llava_next_34b-d64": 0.012, "whisper_small-d64": 0.016}
# test_encdec_on_gpu_matches_cpu's bf16 loss and gradients (relative
# Frobenius error of the worst leaf), card against CPU, about twice the
# readings on the same card: 5.3e-5 and 0.0129 (dec_layers/cross_attn/wk)
ENCDEC_LOSS_TOL, ENCDEC_GRAD_REL = 1.1e-4, 0.026


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


def _stack_case(n, rng, p_push, p_valid, device):
    e = torch.from_numpy(rng.random(n) < p_push).to(device)
    v = torch.from_numpy(rng.random(n) < p_valid).to(device)
    return e, v


# the single-pass scans' tile is TILE ops: its edges, a look-back across
# windows of 32 tiles, and 2^24 + 1 (a ragged last tile at full size)
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 33 * TILE + 7,
                               (1 << 24) + 1])
def test_stack_scan_kernel_tile_edges(cuda, n):
    rng = np.random.default_rng(n)
    for p_push, p_valid in ((0.65, 1.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.8)):
        e, v = _stack_case(n, rng, p_push, p_valid, cuda)
        for last, tick in ((0, 0), (1_000_000, 5_000_000)):
            a, b = _i32(last, cuda), _i32(tick, cuda)
            got = stack_scan(e, v, a, b)
            # the plain version on the card: integers, so the device does
            # not change it, and 2^24 ops stay quick
            for x, y in zip(got, stack_scan_ref(e, v, a, b)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 33 * TILE + 7,
                               (1 << 24) + 1])
def test_queue_scan_kernel_tile_edges(cuda, n):
    """The FIFO scan through its wrapper, three mixes, and states from
    the empty queue to one near 2^29."""
    rng = np.random.default_rng(n)
    for p_enq, p_valid in ((0.65, 1.0), (0.0, 1.0), (0.5, 0.8)):
        e, v = _stack_case(n, rng, p_enq, p_valid, cuda)
        for f, l in ((0, -1), (1_000_000, 1_005_000),
                     (2 ** 29 - 3000, 2 ** 29)):
            a, b = _i32(f, cuda), _i32(l, cuda)
            want = queue_scan_ref(e, v, a, b)
            for x, y in zip(queue_scan(e, v, a, b), want):
                assert torch.equal(x, y)


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, (1 << 24) + 1])
@pytest.mark.parametrize("n_tiers", [1, 4, 64, 256])
def test_tiered_scan_kernel_tile_edges(cuda, n, n_tiers):
    rng = np.random.default_rng(n + n_tiers)
    tier = torch.from_numpy(rng.integers(-1, n_tiers + 1, n).astype(
        np.int32)).to(cuda)
    lasts = torch.from_numpy(rng.integers(-1, 1000, n_tiers).astype(
        np.int32)).to(cuda)
    for p_enq in (1.0, 0.0, 0.7):
        enq = torch.from_numpy(rng.random(n) < p_enq).to(cuda)
        got = tiered_queue_scan(enq, tier, lasts, lasts, n_tiers)
        for x, y in zip(got, tiered_queue_scan_ref(enq, tier, lasts)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [TILE + 1, 65_536, (1 << 24) + 1])
@pytest.mark.parametrize("n_tiers", [257, 512])
def test_tiered_scan_kernel_groups_tiers(cuda, n, n_tiers):
    """More tiers than one launch takes: two launches, one per group of
    256 re-based tiers, bit-identical to the plain sweep."""
    rng = np.random.default_rng(n + n_tiers)
    tier = torch.from_numpy(rng.integers(-1, n_tiers + 1, n).astype(
        np.int32)).to(cuda)
    lasts = torch.from_numpy(rng.integers(-1, 1000, n_tiers).astype(
        np.int32)).to(cuda)
    lasts[-1] = 2 ** 31 - 5                     # wraps like int32 sums
    for p_enq in (1.0, 0.0, 0.7):
        enq = torch.from_numpy(rng.random(n) < p_enq).to(cuda)
        before = tiered_queue_scan.launches
        got = tiered_queue_scan(enq, tier, lasts, lasts, n_tiers)
        assert tiered_queue_scan.launches == before + 2
        for x, y in zip(got, tiered_queue_scan_ref(enq, tier, lasts)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_scan_kernels_take_unaligned_views(cuda, offset):
    """A contiguous view whose base is not 16-byte aligned: the kernels
    load (and store) it with scalar accesses where vector ones would
    fault."""
    rng = np.random.default_rng(offset)
    n = 2 * TILE + 5
    big_e, big_v = _stack_case(n + 16, rng, 0.6, 0.9, cuda)
    e, v = big_e[offset:offset + n], big_v[16 - offset:16 - offset + n]
    assert e.data_ptr() % 16 and v.data_ptr() % 16
    a, b = _i32(3, cuda), _i32(40, cuda)
    for x, y in zip(stack_scan(e, v, a, b), stack_scan_ref(e, v, a, b)):
        assert torch.equal(x, y)
    for x, y in zip(queue_scan(e, v, a, b), queue_scan_ref(e, v, a, b)):
        assert torch.equal(x, y)
    big_t = torch.from_numpy(rng.integers(0, 4, n + 4).astype(
        np.int32)).to(cuda)
    tier = big_t[offset % 4 or 1:][:n]
    assert tier.data_ptr() % 16
    lasts = _i32([5, 0, -1, 70], cuda)
    for x, y in zip(tiered_queue_scan(e, tier, lasts, lasts, 4),
                    tiered_queue_scan_ref(e, tier, lasts)):
        assert torch.equal(x, y)


def test_scan_kernels_2000_back_to_back_calls(cuda):
    """2,000 calls queued without a sync between them, FIFO, stack and
    tiered in turn (they share the stream's status buffer), n and inputs
    changing every call; then each output is checked.  A flag left from
    an earlier call, or an epoch that did not move, shows here."""
    rng = np.random.default_rng(2000)
    runs = []
    for k in range(2000):
        n = int(rng.integers(1, 6 * TILE))
        e, v = _stack_case(n, rng, rng.random(), 0.9, cuda)
        if k % 3 == 1:
            P = 8 if k % 2 else 24
            tier = torch.from_numpy(rng.integers(-1, P + 1, n).astype(
                np.int32)).to(cuda)
            lasts = torch.from_numpy(rng.integers(0, 100, P).astype(
                np.int32)).to(cuda)
            args = (e, tier, lasts)
            runs.append(("tiered", args, tiered_queue_scan(
                e, tier, lasts, lasts, P)))
        elif k % 3 == 2:
            args = (e, v, _i32(k, cuda), _i32(k + n // 3, cuda))
            runs.append(("fifo", args, queue_scan(*args)))
        else:
            args = (e, v, _i32(k, cuda), _i32(3 * k, cuda))
            runs.append(("stack", args, stack_scan(*args)))
    torch.cuda.synchronize()
    plain = {"tiered": tiered_queue_scan_ref, "fifo": queue_scan_ref,
             "stack": stack_scan_ref}
    for kind, args, got in runs:
        for x, y in zip(got, plain[kind](*args)):
            assert torch.equal(x, y)


def test_scan_kernels_refuse_cuda_graph_capture(cuda):
    """A replay would repeat the captured call's epoch, and the previous
    replay's flags would read as this call's: every segscan call under
    capture raises before it launches."""
    n = 3 * TILE + 5
    rng = np.random.default_rng(5)
    e, v = _stack_case(n, rng, 0.6, 0.9, cuda)
    tier = torch.zeros(n, dtype=torch.int32, device=cuda)
    lasts = _i32([0, 0, 0], cuda)
    a, b = _i32(0, cuda), _i32(-1, cuda)
    calls = [lambda: queue_scan(e, v, a, b), lambda: stack_scan(e, v, a, a),
             lambda: tiered_queue_scan(e, tier, lasts, lasts, 3)]
    for fn in calls:
        fn()                            # builds, and the status buffer
    torch.cuda.synchronize()
    for fn in calls:
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(g):
                fn()
    for x, y in zip(queue_scan(e, v, a, b), queue_scan_ref(e, v, a, b)):
        assert torch.equal(x, y)      # the stream's buffer still works


def test_stack_scan_kernel_ticket_wraps(cuda):
    """The ticket sum wraps like the reference's int32 (the kernel sums
    it in uint32: signed overflow is undefined in C++)."""
    rng = np.random.default_rng(7)
    n = 3 * TILE + 11
    e, v = _stack_case(n, rng, 0.8, 1.0, cuda)
    a, b = _i32(10, cuda), _i32(2 ** 31 - 1000, cuda)
    got = stack_scan(e, v, a, b)
    assert int(got[4]) < 0 and int(got[1].min()) < 0    # it did wrap
    for x, y in zip(got, stack_scan_ref(e, v, a, b)):
        assert torch.equal(x, y)


def _kernels_per_call(fn, reps=10):
    """{kernel name: launches a call} of ``fn`` by the profiler, after a
    warm-up call (the lead-in spin kernel left out; a session that lost
    its first kernels runs again, as test_scan_kernels_one_launch_per_call
    does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call = {}
        for ev in prof.key_averages():
            if (ev.device_type == DeviceType.CUDA and ev.count
                    and "spin_kernel" not in ev.key):
                m = re.search(r"::(\w+)", ev.key)
                name = m.group(1) if m else ev.key
                per_call[name] = per_call.get(name, 0) + ev.count / reps
        seen.append(per_call)
        if all(c == 1 for c in per_call.values()):
            break
    return seen[-1]


def test_scan_kernels_one_launch_per_call(cuda):
    """By the profiler's kernel names, in one profiled window: the FIFO,
    stack and tiered scans run one kernel per call."""
    rng = np.random.default_rng(1)
    n = 65_536
    e, v = _stack_case(n, rng, 0.65, 1.0, cuda)
    tier = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(cuda)
    lasts = _i32([0, 0, 0, 0], cuda)
    a, b = _i32(0, cuda), _i32(-1, cuda)
    calls = [lambda: stack_scan(e, v, a, b),
             lambda: tiered_queue_scan(e, tier, lasts, lasts, 4),
             lambda: queue_scan(e, v, a, b)]
    want = {"stack_scan_lookback": 1, "tiered_scan_lookback": 1,
            "queue_scan_lookback": 1}
    per_call = _kernels_per_call(lambda: [fn() for fn in calls])
    assert per_call == want


@pytest.mark.parametrize("n_shards", [1, 48, 64, 1000, HASH_MAX_SHARDS])
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


@pytest.mark.parametrize("n", [1, 39_102, 65_536])
def test_hash_route_one_launch_and_repeatable(cuda, n):
    """One kernel a call (no zero-fill before it: the outputs are
    torch.empty), and two calls in a row bit-identical to each other and
    to the plain version: anything a call left behind would show in the
    second.  n = 1 (one block), a ragged n (the four-element groups'
    tail), 65,536 (the migrations' largest, a cluster of 16)."""
    rng = np.random.default_rng(n)
    pos = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n,
                                        dtype=np.int64).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    want = hash_route_ref(pos, valid, 48)
    p, v = pos.to(cuda), valid.to(cuda)
    first = hash_route(p, v, 48)
    second = hash_route(p, v, 48)
    for a, b, c in zip(first, second, want):
        assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)
    per_call = _kernels_per_call(lambda: hash_route(p, v, 48))
    assert per_call == {"hash_route": 1}, per_call
    if n > 1:                 # a view off 16-byte alignment: scalar path
        for a, b in zip(hash_route(p[1:], v[1:], 48),
                        hash_route_ref(pos[1:], valid[1:], 48)):
            assert torch.equal(a.cpu(), b)


def test_hash_route_replays_in_a_cuda_graph(cuda):
    """The kernel keeps no state between calls, so a captured call
    replays: new positions copied into the captured input give their
    own owners and counts, replay after replay."""
    rng = np.random.default_rng(11)
    pos = torch.zeros(70_000, dtype=torch.int32, device=cuda)
    valid = torch.ones(70_000, dtype=torch.bool, device=cuda)
    hash_route(pos, valid, 64)               # the build, outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        owner, counts = hash_route_kernel(pos, valid, 64)
    for _ in range(3):
        p = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 70_000,
                                          dtype=np.int64).astype(np.int32))
        v = torch.from_numpy(rng.random(70_000) < 0.9)
        pos.copy_(p)
        valid.copy_(v)
        g.replay()
        want = hash_route_ref(p, v, 64)
        assert torch.equal(owner.cpu(), want[0])
        assert torch.equal(counts.cpu(), want[1])


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


def test_elastic_priority_300_tiers_on_gpu_matches_cpu(cuda):
    """300 tiers (two tiered launches a wave) on 4 shards through a JOIN
    and a LEAVE, on the card against the same waves on the CPU."""
    runs = []
    for dev in ("cpu", cuda):
        eq = ElasticDevicePriorityQueue(4, n_prios=300, cap=16,
                                        payload_width=2, ops_per_shard=16,
                                        pool_size=8, device=dev)
        res, r = [], np.random.default_rng(300)
        for i, action in enumerate([None, None, ("grow", 2), None,
                                    ("shrink", [0, 3]), None]):
            if action is not None:
                st = (eq.grow(action[1]) if action[0] == "grow"
                      else eq.shrink(action[1]))
                assert st["moved"] == eq.size
                continue
            E, V, P = _waves(eq.n_shards, 16, 2, 3, seed=i)
            PR = torch.from_numpy(r.integers(0, 300, E.shape).astype(
                np.int32))
            before = tiered_queue_scan.launches
            res += [x.cpu() for x in eq.run_waves(
                E.to(dev), V.to(dev), PR.to(dev), P.to(dev))]
            if dev != "cpu":
                assert tiered_queue_scan.launches == before + 6
        st = eq.state
        runs.append(res + [st.firsts.cpu(), st.lasts.cpu(),
                           st.store_full.cpu(),
                           st.store_vals[:, :300 * 16].cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Lq, Lk, D, causal, window, dtype)
    (2, 4, 4, 256, 256, 64, True, None, torch.bfloat16),
    (1, 8, 2, 200, 200, 128, True, None, torch.bfloat16),    # GQA, ragged
    (1, 4, 4, 333, 1000, 64, True, 100, torch.bfloat16),     # window
    (2, 2, 2, 128, 128, 32, False, None, torch.float32),
    (1, 4, 1, 1, 130, 64, True, None, torch.float32),        # one query
    (1, 4, 2, 70, 70, 32, True, 8, torch.float32),
    # tensor-core route: Lq no multiple of 128, Lq < Lk, a window across
    # a tile edge, D = 128 GQA, a query tile of 64 rows, not causal
    (2, 4, 4, 300, 300, 64, True, None, torch.bfloat16),
    (1, 4, 2, 100, 300, 64, True, None, torch.bfloat16),
    (2, 4, 4, 300, 300, 64, True, 70, torch.bfloat16),
    (1, 8, 2, 256, 256, 128, True, None, torch.bfloat16),
    (1, 4, 4, 64, 64, 128, True, 16, torch.bfloat16),
    (1, 2, 1, 130, 200, 64, False, None, torch.bfloat16),
    (1, 4, 4, 40, 40, 64, True, None, torch.bfloat16),      # scalar route
    # the moe, vlm and encdec families' shapes, cut in length: whisper's
    # encoder (not causal, 1,500 keys: no tile multiple), its
    # cross-attention (448 queries against 1,500 keys), Lq > Lk unmasked,
    # llava's 56 query heads over 8 at D 128 (G 7), granite-moe's G 2
    (1, 4, 4, 1500, 1500, 64, False, None, torch.bfloat16),
    (2, 4, 4, 448, 1500, 64, False, None, torch.bfloat16),
    (1, 4, 4, 1000, 300, 64, False, None, torch.bfloat16),
    (1, 14, 2, 300, 300, 128, True, None, torch.bfloat16),
    (1, 16, 8, 256, 256, 64, True, None, torch.bfloat16),
])
def test_flash_attention_kernel_matches_plain(cuda, case):
    """The kernel against its plain version on the same CUDA tensors, q in
    the model's [B, L, H, D] layout (strided).  Tolerance per element: f32
    2e-5 abs (summation order); bf16 2^-7 |want| + 1e-5 (both round an f32
    result to bf16 once, so they sit at most one bf16 step apart, plus the
    f32 orders' difference near 0), as chip_smoke.py holds the path's
    shapes."""
    B, Hq, Hkv, Lq, Lk, D, causal, window, dt = case
    g = torch.Generator().manual_seed(Lq + Lk + D)
    q = torch.randn(B, Lq, Hq, D, generator=g).to(cuda, dt).transpose(1, 2)
    k, v = (torch.randn(B, Hkv, Lk, D, generator=g).to(cuda, dt)
            for _ in range(2))
    before, tc_before = flash_attention.launches, flash_attention.tc_launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    assert flash_attention.tc_launches == tc_before + tc_route(dt, D, Lq)
    want = attention_chunked(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (B, Hq, Lq, D)
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    limit = 2e-5 if dt == torch.float32 else 2.0 ** -7 * w + 1e-5
    assert bool((d <= limit).all()), float(d.max())


@pytest.mark.parametrize("b,H,L,P,N,bc,shared", [
    (2, 3, 100, 16, 16, torch.bfloat16, True),     # ragged, reduced widths
    (1, 4, 256, 64, 64, torch.bfloat16, True),     # zamba2's head and state
    (2, 2, 130, 64, 128, torch.float32, True),     # mamba2-130m's state
    (1, 2, 1, 32, 16, torch.float32, True),
    # L no chunk multiple and H no multiple of the 8-head group
    (2, 12, 1000, 64, 64, torch.bfloat16, True),
    (1, 10, 333, 32, 128, torch.bfloat16, True),
    # B/C per head (head stride not 0)
    (2, 3, 300, 64, 64, torch.float32, False),
    (1, 9, 200, 64, 64, torch.bfloat16, False),
])
def test_ssd_scan_kernel_matches_plain(cuda, b, H, L, P, N, bc, shared):
    """The kernel against its plain version on the same CUDA tensors, in
    the model's form: xt/loga as views of [b, L, H, ...] buffers, B/C a
    stride-0 expand of [b, L, N] (or per head, a view of [b, L, H, N]).
    Tolerance 1e-4 of max |y|: f32 in another summation order, through the
    carried state."""
    g = torch.Generator().manual_seed(L + P + N)
    xt = torch.randn(b, L, H, P, generator=g).to(cuda).transpose(1, 2)
    loga = (-torch.rand(b, L, H, generator=g) * 0.2).to(cuda).transpose(1, 2)
    if shared:
        B, C = ((torch.randn(b, L, N, generator=g) * 0.3).to(cuda, bc)[
            :, None].expand(b, H, L, N) for _ in range(2))
    else:
        B, C = ((torch.randn(b, L, H, N, generator=g) * 0.3).to(cuda, bc)
                .transpose(1, 2) for _ in range(2))
    before = ssd_scan.launches
    got = ssd_scan(xt, loga, B, C)
    assert ssd_scan.launches == before + 1
    want = ssd_chunked_ref(xt, loga, B, C)
    torch.cuda.synchronize()
    assert got.shape == (b, H, L, P) and got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4, err


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch,head_dim", [
    pytest.param("zamba2_1p2b", 32, id="zamba2_1p2b"),
    pytest.param("mamba2_130m", 32, id="mamba2_130m"),
    pytest.param("llama3_8b", 32, id="llama3_8b"),
    # head dim 64: the bf16 prefill takes the tensor-core flash kernel
    pytest.param("zamba2_1p2b", 64, id="zamba2_1p2b-d64"),
    pytest.param("llama3_8b", 64, id="llama3_8b-d64"),
    pytest.param("granite_moe_1b", 64, id="granite_moe_1b-d64"),
    pytest.param("llava_next_34b", 64, id="llava_next_34b-d64"),
])
def test_model_on_gpu_matches_cpu(cuda, request, arch, head_dim):
    """A reduced model on the card (both kernels) against the same model
    on the CPU (their plain versions): the prefill of a 100-token prompt
    (no multiple of any tile) and four decode steps.  Tolerance
    ``GPU_CPU_LOGIT_TOL`` on logits: bf16 products round at other places
    in cuBLAS than on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    case = request.node.callspec.id
    cfg = get_config(arch).reduced(head_dim=head_dim)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    gparams = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    f0, s0 = flash_attention.launches, ssd_scan.launches
    tc0 = flash_attention.tc_launches
    got = model.prefill(gparams, toks.to(cuda))
    n_attn = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
              "ssm": 0}.get(cfg.family, cfg.n_layers)
    n_ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert flash_attention.launches - f0 == n_attn
    assert flash_attention.tc_launches - tc0 == (n_attn if head_dim == 64
                                                 else 0)
    assert ssd_scan.launches - s0 == n_ssd
    want = model.prefill(params, toks)
    gaps = [float((got.cpu() - want).abs().max())]
    gc = model.init_cache(2, 8, device=cuda)
    cc = model.init_cache(2, 8, device="cpu")
    for t in range(4):
        pos = torch.tensor([t, t + 1])
        gl, gc = model.decode_fn(gparams, gc, toks[:, t:t + 1].to(cuda),
                                 pos.to(cuda))
        cl, cc = model.decode_fn(params, cc, toks[:, t:t + 1], pos)
        gaps.append(float((gl.cpu() - cl).abs().max()))
    print(f"{case}: max |Δlogit| card vs CPU, prefill then decode: {gaps}")
    assert max(gaps) < GPU_CPU_LOGIT_TOL[case], gaps


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_encdec_on_gpu_matches_cpu(cuda):
    """Reduced whisper-small at head dim 64 on the card against the CPU:
    the prefill (encoder: bidirectional flash over 100 frames; decoder:
    causal flash and cross-attention flash, all on the tensor-core
    route), a training step's loss and gradients (the backward kernels,
    cross-attention's dk and dv over every frame), and four decode steps
    against the same encoder states."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("whisper_small").reduced(head_dim=64, enc_seq=100)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    gparams = _to(params, cuda)
    g = torch.Generator().manual_seed(0)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 81)))
    tc0 = flash_attention.tc_launches
    got = model.prefill(gparams, toks[:, :80].to(cuda),
                        frames=frames.to(cuda))
    n_attn = cfg.enc_layers + 2 * cfg.n_layers
    assert flash_attention.tc_launches - tc0 == n_attn
    want = model.prefill(params, toks[:, :80], frames=frames)
    gaps = [float((got.cpu() - want).abs().max())]
    genc, cenc = model.encode(gparams, frames.to(cuda)), model.encode(
        params, frames)
    gc = model.init_cache(2, 8, device=cuda)
    cc = model.init_cache(2, 8, device="cpu")
    for t in range(4):
        gl, gc = model.decode_fn(gparams, gc, toks[:, t:t + 1].to(cuda), t,
                                 enc_out=genc)
        cl, cc = model.decode_fn(params, cc, toks[:, t:t + 1], t,
                                 enc_out=cenc)
        gaps.append(float((gl.cpu() - cl).abs().max()))
    from repro_torch.train.train_step import value_and_grad
    b0 = flash_attention.bwd_tc_launches
    runs = []
    for p, dev in ((gparams, cuda), (params, "cpu")):
        batch = {"frames": frames.to(dev), "tokens": toks[:, :80].to(dev),
                 "targets": toks[:, 1:].to(dev)}
        runs.append(value_and_grad(model, p, batch))
        if dev == cuda:
            assert flash_attention.bwd_tc_launches - b0 == n_attn
    loss_gap = abs(float(runs[0][0]) - float(runs[1][0]))
    rel = {k: float((a.float().cpu() - b.float()).norm()
                    / b.float().norm())
           for (k, a), (_, b) in zip(_named_leaves(runs[0][1]),
                                     _named_leaves(runs[1][1]))}
    worst = max(rel, key=rel.get)
    print(f"whisper_small-d64: max |Δlogit| card vs CPU, prefill then "
          f"decode: {gaps}; loss gap {loss_gap}; worst gradient {worst} "
          f"{rel[worst]}")
    assert max(gaps) < GPU_CPU_LOGIT_TOL["whisper_small-d64"], gaps
    assert loss_gap < ENCDEC_LOSS_TOL
    assert rel[worst] < ENCDEC_GRAD_REL, worst


# ------------------------------------------------------------------ Seap --
I32MIN, I32MAX = -(2 ** 31), 2 ** 31 - 1


def _seap_keys(shape, seed):
    """Keys over [-1000, 1000) with clusters at both int32 edges."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-1000, 1000, shape)
    edge = rng.random(shape)
    key[edge < 0.05], key[edge > 0.95] = I32MIN, I32MAX
    return torch.from_numpy(key.astype(np.int32))


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_seap_queue_64_shards_on_gpu_matches_cpu(cuda, pipelined):
    """64 shards x 8 buckets, a low split threshold (splits and on-demand
    merges): the card's bursts bit-identical to the CPU's, one tiered
    launch a wave."""
    E, V, P = _waves(64, 16, 2, 4, seed=7)
    KY = _seap_keys(E.shape, seed=7)
    outs = []
    for dev in ("cpu", cuda):
        q = DeviceSeapQueue(64, n_buckets=8, cap=64, payload_width=2,
                            ops_per_shard=16, split_occupancy=200,
                            seed_bounds=[-500, 0, 500],
                            pipelined=pipelined, device=dev)
        st, res = q.init_state(), []
        for mix in (E, ~E):                 # enqueue-heavy, then dequeue
            before = tiered_queue_scan.launches
            st, *o = q.run_waves(st, mix.to(dev), V.to(dev), KY.to(dev),
                                 P.to(dev))
            if dev != "cpu":
                assert tiered_queue_scan.launches == before + 4
            res += [x.cpu() for x in o]
        outs.append(res + [x.cpu() for x in st[:6]]
                    + [st.store_vals[:, :8 * 64].cpu(), st.store_full.cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert len(set(outs[1][6].tolist())) > 1, "the directory never changed"


def test_elastic_seap_on_gpu_matches_cpu_through_join_and_leave(cuda):
    runs = []
    for dev in ("cpu", cuda):
        eq = ElasticDeviceSeapQueue(4, n_buckets=4, cap=32, payload_width=2,
                                    ops_per_shard=4, split_occupancy=6,
                                    pool_size=8, device=dev)
        res = []
        for i, action in enumerate([None, ("grow", 2), None,
                                    ("shrink", [0, 2, 4]), None,
                                    ("grow", 2), None]):
            if action is None:
                E, V, P = _waves(eq.n_shards, 4, 2, 3, seed=i)
                KY = _seap_keys(E.shape, seed=i)
                res += [x.cpu() for x in eq.run_waves(
                    E.to(dev), V.to(dev), KY.to(dev), P.to(dev))]
            else:
                st = (eq.grow(action[1]) if action[0] == "grow"
                      else eq.shrink(action[1]))
                assert st["moved"] == eq.size
                res.append(torch.tensor(st["hash_balance"]["counts"]))
                res.append(torch.tensor(eq.directory()))
        runs.append(res + [x.cpu() for x in eq.state[:6]]
                    + [eq.state.store_vals[:, :4 * 32].cpu(),
                       eq.state.store_full.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["seap", "priority", "fifo", "stack",
                                  "relaxed", "metrics_seap",
                                  "metrics_priority", "metrics_fifo",
                                  "metrics_stack"])
def test_pipelined_burst_makes_no_host_sync(cuda, kind):
    """A pipelined burst (dispatch, both exchanges and the commit) on
    inputs already on the card runs under
    ``set_sync_debug_mode("error")``: the Seap wave's directory lookup,
    tiered sweep, DeleteMin and rebalance, the strict and relaxed
    priority waves (the relaxed kernel's launch), the FIFO and stack
    waves, and each of them with the telemetry ring on."""
    E, V, P = _waves(64, 16, 2, 4, seed=11)
    metrics = kind.startswith("metrics_")
    base = kind.split("_")[-1]
    kw = dict(cap=64, payload_width=2, ops_per_shard=16, metrics=metrics,
              device=cuda)
    extra = []
    if base == "seap":
        q = DeviceSeapQueue(64, n_buckets=8, split_occupancy=100, **kw)
        extra = [_seap_keys(E.shape, seed=11)]
    elif base in ("priority", "relaxed"):
        q = DevicePriorityQueue(64, n_prios=4,
                                relaxation=int(base == "relaxed"), **kw)
        extra = [torch.from_numpy(np.random.default_rng(11).integers(
            0, 4, E.shape).astype(np.int32))]
    elif base == "fifo":
        q = DeviceQueue(64, **kw)
    else:
        q = DeviceStack(64, slot_depth=4, **kw)
    args = [x.to(cuda) for x in (E, V, *extra, P)]
    st, *_ = q.run_waves(q.init_state(), *args)     # builds, allocates
    torch.cuda.synchronize()
    before = relaxed_deletemin.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, *out = q.run_waves(st, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[q.engine.disc.n_disp_outs + 1].any()  # dequeues found values
    assert relaxed_deletemin.launches == before + 4 * (base == "relaxed")
    if metrics:
        assert len(q.drain_metrics()) == 8


def test_edf_engine_on_gpu_admits_as_on_cpu(cuda):
    """The EDF engine with deferral and a resize 3 -> 4, on the card and
    on the CPU: the same admissions, deadline outcome and metrics (token
    values aside, which admission never reads)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("mamba2_130m").reduced(n_layers=2)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    runs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        eng = ServeEngine(model, p, 3, max_slots=3, max_seq=24,
                          deadline=True, n_buckets=8, deadline_horizon=32,
                          admission="defer", queue_cap=3, pool_size=4,
                          device=dev)
        rng = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
            1, cfg.vocab, 3)], max_new=3) for i in range(18)]
        before = tiered_queue_scan.launches
        eng.submit(reqs[:12], deadline=30)         # three are deferred
        eng.step()
        eng.submit(reqs[12:], deadline=2)
        eng.step()
        eng.resize(4)
        assert eng.run_until_drained(max_steps=400)
        if dev != "cpu":
            assert tiered_queue_scan.launches > before
        m = eng.metrics()
        m["admission_control"] = {
            k: v for k, v in m["admission_control"].items()
            if not k.startswith("decide_us")}
        runs.append(([(r.rid, r.start_step, r.finish_step, r.deadline)
                      for r in reqs], eng.deadline_stats(), m))
    assert runs[0] == runs[1]


# ------------------------------------------------ relaxed tier resolution -
@pytest.mark.parametrize("n,P,k,n_shards,kind", [
    (65_536, 4, 1, 64, "mixed"), (65_536, 4, 2, 64, "mixed"),
    (65_536, 300, 2, 64, "mixed"), (65_536, 4, 1, 64, "empty"),
    (65_536, 4, 2, 64, "edge"), (70_000, 40, 40, 64, "mixed"),
    (5_000, 64, 33, 8, "mixed"), (1, 1, 1, 1, "mixed"),
    (4_097, 33, 1, 1, "edge"), (65_536, 1000, 3, 48, "mixed"),
    (65_536, 4, 2, 48, "edge"), (65_536, 8, 3, 2, "mixed"),
    (65_536, 16, 5, 3, "edge"), (65_536, 4, 2, 100, "mixed"),
    (20_000, 12, 3, 1000, "edge"), (4_000, MAX_TIERS, 3, 1000, "mixed")])
def test_relaxed_kernel_matches_plain(cuda, n, P, k, n_shards, kind):
    """One launch against the plain host loop, bit for bit: full waves,
    300 and 1,000 tiers (the register window moves), a relaxation wider
    than the window (k > 31), all tiers empty (every reply ⊥), heads at
    INT32_MAX that wrap (at 48 and 3 shards too, which do not divide
    2^32), frequent relaxed serves (2 and 3 shards), one shard, more
    than 64 shards (the owner table in shared memory), and MAX_TIERS tiers
    beside 1,000 shards (the most shared memory a launch takes)."""
    rng = np.random.default_rng(n + P + k)
    deq = rng.random(n) < 0.5
    so = (np.arange(n) * n_shards // n).astype(np.int32)
    avail = (np.zeros(P, np.int64) if kind == "empty"
             else rng.integers(0, max(2, n // P), P))
    avail[rng.random(P) < 0.2] = 0
    firsts = rng.integers(-1000, 1000, P)
    if kind == "edge":
        firsts = 2 ** 31 - 1 - rng.integers(0, 8, P)
    args = [torch.from_numpy(x) for x in (
        deq, so, avail.astype(np.int32), firsts.astype(np.int32))]
    want = relaxed_deletemin_ref(*args, P, k, n_shards)
    before = relaxed_deletemin.launches
    got = relaxed_deletemin(*(x.to(cuda) for x in args), P, k, n_shards)
    assert relaxed_deletemin.launches == before + 1
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
    if kind == "empty":
        assert not got[2].any()
    if kind == "edge":
        assert (got[1][got[2]] < 0).any()          # heads wrapped


def _cell_wave(P, n_shards, kind, seed=0, n=65_536, backlog=300_000):
    """A shard-major wave as the priority path sends it (op i on shard
    i * n_shards // n), half dequeues, tier sizes of a backlog-deep queue;
    "edge": every head within 64 of INT32_MAX, so the first run of each
    tier crosses the int32 wrap in the middle of a 256-dequeue step."""
    rng = np.random.default_rng(seed)
    deq = rng.random(n) < 0.5
    so = (np.arange(n) * n_shards // n).astype(np.int32)
    avail = rng.integers(backlog // (2 * P), backlog // P + 1, P)
    firsts = rng.integers(0, 1_000_000, P)
    if kind == "edge":
        avail = rng.integers(n // (2 * P), n // P + 1, P)
        firsts = 2 ** 31 - 1 - rng.integers(0, 64, P)
    return [torch.from_numpy(x) for x in (
        deq, so, avail.astype(np.int32), firsts.astype(np.int32))]


@pytest.mark.parametrize("P,k,n_shards,kind", [
    (4, 1, 64, "mixed"), (4, 2, 64, "mixed"), (300, 2, 64, "mixed"),
    (4, 2, 48, "edge")])
def test_relaxed_kernel_cell_waves_and_clock_build(cuda, P, k, n_shards,
                                                   kind):
    """Shard-major waves at the cells' size (65,536 ops, 64 shards) and a
    run that crosses the int32 wrap mid-step at 48 shards: one launch bit
    for bit against the plain loop; the clock build gives the same
    outputs and counts the walk model's steps, relaxed serves, dry events
    and dequeues."""
    args = _cell_wave(P, n_shards, kind)
    want = relaxed_deletemin_ref(*args, P, k, n_shards)
    *_, model = relaxed_walk_model(*args, P, k, n_shards)
    dev_args = [x.to(cuda) for x in args]
    before = relaxed_deletemin.launches
    got = relaxed_deletemin(*dev_args, P, k, n_shards)
    assert relaxed_deletemin.launches == before + 1
    stats = torch.zeros(STATS, dtype=torch.int64, device=cuda)
    clocked = relaxed_deletemin_kernel(*dev_args, P, k, n_shards,
                                       stats=stats)
    for a, b, c in zip(got, clocked, want):
        assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)
    steps, relaxed, dry, cycles, wait, _, walked, _ = stats.tolist()
    assert (steps, relaxed, dry, walked) == (
        model["steps"], model["relaxed"], model["dry"], model["dequeues"])
    assert 0 <= wait < cycles
    if kind == "edge":
        assert (got[1][got[2]] < 0).any()          # heads wrapped


def test_elastic_relaxed_64_shards_on_gpu_matches_cpu(cuda):
    """A 64-shard relaxed priority queue (relaxation 1) through a LEAVE of
    16 and a JOIN of 16, on the card against the CPU: one relaxed launch
    a wave, every output and the final state equal."""
    runs = []
    for dev in ("cpu", cuda):
        eq = ElasticDevicePriorityQueue(64, n_prios=4, relaxation=1, cap=64,
                                        payload_width=2, ops_per_shard=16,
                                        device=dev)
        res, r = [], np.random.default_rng(64)
        for i, action in enumerate([None, ("shrink", list(range(0, 64, 4))),
                                    None, ("grow", 16), None]):
            if action is not None:
                st = (eq.grow(action[1]) if action[0] == "grow"
                      else eq.shrink(action[1]))
                assert st["moved"] == eq.size
                continue
            E, V, P = _waves(eq.n_shards, 16, 2, 3, seed=20 + i)
            PR = torch.from_numpy(r.choice(4, E.shape, p=[0.4, 0.3, 0.2,
                                                          0.1]).astype(
                np.int32))
            before = relaxed_deletemin.launches
            res += [x.cpu() for x in eq.run_waves(
                E.to(dev), V.to(dev), PR.to(dev), P.to(dev))]
            if dev != "cpu":
                assert relaxed_deletemin.launches == before + 3
        st = eq.state
        runs.append(res + [st.firsts.cpu(), st.lasts.cpu(),
                           st.store_full.cpu(),
                           st.store_vals[:, :4 * 64].cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert int(sum(x.sum() for x in runs[1][6::7])) > 0  # some relaxed


@pytest.mark.parametrize("kind", ["fifo", "stack", "relaxed", "seap"])
def test_metrics_burst_on_gpu_matches_cpu(cuda, kind):
    """A metrics-on pipelined burst on 64 shards: the drained rows and
    every output on the card equal the CPU's."""
    E, V, P = _waves(64, 16, 2, 4, seed=12)
    runs = []
    for dev in ("cpu", cuda):
        kw = dict(cap=64, payload_width=2, ops_per_shard=16, metrics=True,
                  metrics_ring=6, device=dev)
        extra = []
        if kind == "seap":
            q = DeviceSeapQueue(64, n_buckets=8, split_occupancy=100, **kw)
            extra = [_seap_keys(E.shape, seed=12)]
        elif kind == "relaxed":
            q = DevicePriorityQueue(64, n_prios=4, relaxation=1, **kw)
            extra = [torch.from_numpy(np.random.default_rng(12).integers(
                0, 4, E.shape).astype(np.int32))]
        elif kind == "fifo":
            q = DeviceQueue(64, **kw)
        else:
            q = DeviceStack(64, slot_depth=4, **kw)
        args = [x.to(dev) for x in (E, V, *extra, P)]
        st, *o1 = q.run_waves(q.init_state(), *args)
        st, *o2 = q.run_waves(st, *args)            # the ring wraps
        runs.append(([x.cpu() for x in o1 + o2], q.drain_metrics()))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert runs[0][1] == runs[1][1]
    assert [r["seq"] for r in runs[1][1]] == [2, 3, 4, 5, 6, 7]


def test_checkpoint_round_trip_on_gpu(cuda, tmp_path):
    """Save a card queue, restore it at another shard count on the card
    and on the CPU: the same state and the same next burst."""
    eq = ElasticDeviceQueue(8, cap=64, payload_width=2, ops_per_shard=16,
                            device=cuda)
    E, V, P = _waves(8, 16, 2, 4, seed=13)
    eq.run_waves(E.to(cuda), V.to(cuda), P.to(cuda))
    eq.save(tmp_path, 1)
    runs = []
    for dev in ("cpu", cuda):
        r = ElasticDeviceQueue.restore(tmp_path, n_shards=6, device=dev)
        assert r.device.type == torch.device(dev).type and r.n_shards == 6
        E2, V2, P2 = _waves(6, 16, 2, 3, seed=14)
        out = r.run_waves(E2.to(dev), V2.to(dev), P2.to(dev))
        runs.append([x.cpu() for x in out]
                    + [r.state.store_vals[:, :64].cpu(),
                       r.state.store_full.cpu(), r.state.first.cpu(),
                       r.state.last.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_seed_wave_on_gpu_matches_cpu_and_the_fused_wave(cuda):
    """``DeviceQueue(fused=False)`` at 64 shards: five exchanges a wave,
    the card's burst equal to the CPU's and to the fused wave's."""
    E, V, P = _waves(64, 16, 2, 4, seed=15)
    runs = []
    for dev, fused in (("cpu", False), (cuda, False), (cuda, True)):
        q = DeviceQueue(64, cap=64, payload_width=2, ops_per_shard=16,
                        fused=fused, device=dev)
        x0 = q.runtime.n_exchanges
        st, *o = q.run_waves(q.init_state(), E.to(dev), V.to(dev),
                             P.to(dev))
        assert q.runtime.n_exchanges - x0 == (5 * 4 if not fused else 5)
        runs.append([x.cpu() for x in o]
                    + [st.store_vals[:, :64].cpu(), st.store_full.cpu()])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


# the two-process schedule of tests/test_torch_distributed.py, each
# process on the card
GPU_CHILD = r"""
import sys
import numpy as np
from repro_torch.runtime import DistributedRuntime
rt = DistributedRuntime.from_env(device="cuda")
for kind in ("fifo", "lifo"):
    out, counts, digest = run(kind, rt)
    if rt.process_role.coordinator:
        np.savez(f"{sys.argv[1]}/{kind}.npz", **out)
rt.close()
"""


def test_two_processes_on_gpu_match_one_process_on_cpu(cuda, tmp_path):
    """Two processes share the card (gloo on CUDA tensors, 4 of 8 shards
    each) through the interleaving LEAVE and JOINs; their gathered outputs
    and final stores equal one process's on the CPU."""
    from test_torch_distributed import SCHEDULE

    from repro_torch.kernels import backend
    from repro_torch.runtime import LocalRuntime, launch_localhost
    backend.build()                    # no child waits on nvcc
    launch_localhost(code=SCHEDULE + GPU_CHILD, args=[str(tmp_path)],
                     n_procs=2, shards_per_process=4, timeout=300)
    ns = {}
    exec(SCHEDULE, ns)
    for kind in ("fifo", "lifo"):
        want, _, _ = ns["run"](kind, LocalRuntime(8, device="cpu"))
        got = dict(np.load(tmp_path / f"{kind}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (kind, k)


# the relaxed schedule of tests/test_torch_distributed_tiers.py, each
# process on the card, counting its kernels' launches
GPU_TIERS_CHILD = r"""
import json, sys
import numpy as np
from repro_torch.kernels.relaxed import relaxed_deletemin
from repro_torch.kernels.segscan import tiered_queue_scan
from repro_torch.runtime import DistributedRuntime
rt = DistributedRuntime.from_env(device="cuda")
out, counts, digest = run("relaxed", rt)
launches = [tiered_queue_scan.launches, relaxed_deletemin.launches,
            sum(k for _, k, _, _ in counts)]
if rt.process_role.coordinator:
    np.savez(f"{sys.argv[1]}/relaxed.npz", **out)
print("RESULT" + json.dumps([digest, launches]))
rt.close()
"""


def test_two_process_relaxed_priority_on_gpu_matches_cpu(cuda, tmp_path):
    """The relaxed priority queue in two processes sharing the card (4 of
    8 shards each) through the interleaving LEAVE and JOINs: gathered
    outputs, relaxed-serve counts and final store equal one process's on
    the CPU, and each process launches the tiered and the relaxed kernel
    once a wave over the same gathered wave."""
    import json

    from test_torch_distributed_tiers import SCHEDULE

    from repro_torch.kernels import backend
    from repro_torch.runtime import LocalRuntime, launch_localhost
    backend.build()                    # no child waits on nvcc
    res = launch_localhost(code=SCHEDULE + GPU_TIERS_CHILD,
                           args=[str(tmp_path)], n_procs=2,
                           shards_per_process=4, timeout=300)
    ns = {}
    exec(SCHEDULE, ns)
    want, _, digest = ns["run"]("relaxed", LocalRuntime(8, device="cpu"))
    got = dict(np.load(tmp_path / "relaxed.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for r in res:
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")]
        got_digest, (tiered, relaxed, waves) = json.loads(line[0][6:])
        assert got_digest == digest
        assert tiered == relaxed == waves > 0


def test_work_queue_on_gpu_matches_cpu(cuda):
    """The seeded WorkQueue scenario of tests/test_torch_work_queue.py:
    grants, stats and leases on the card equal the CPU's."""
    import json

    from test_torch_work_queue import SCENARIO

    from repro_torch.dqueue import WorkQueue
    ns = {"np": np}
    exec(SCENARIO, ns)
    res = []
    for dev in ("cuda", "cpu"):
        dq = DeviceQueue(4, cap=128, payload_width=4, ops_per_shard=16,
                         device=dev)
        res.append(json.loads(json.dumps(
            ns["drive"](WorkQueue(dq, lease_steps=3), 0))))
    assert res[0] == res[1]


def test_hashing_and_synthetic_tokens_on_gpu_match_cpu(cuda):
    """The uint64 bits held in int64 wrap the same on the card: splitmix64,
    hash01 and synthetic_tokens equal the CPU's, bit for bit."""
    from repro_torch.core.hashing import hash01, splitmix64
    from repro_torch.data import synthetic_tokens
    edge = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 63 - 1, 2 ** 63,
                     2 ** 64 - 1], dtype=np.uint64)
    x = np.concatenate([edge, np.random.default_rng(0).integers(
        0, 2 ** 64 - 1, 1 << 16, dtype=np.uint64, endpoint=True)])
    t = torch.from_numpy(x.view(np.int64))
    assert torch.equal(splitmix64(t.to(cuda)).cpu(), splitmix64(t))
    assert torch.equal(hash01(t.to(cuda), 0xD47).cpu(), hash01(t, 0xD47))
    for vocab in (3, 32_000, 2 ** 31 - 1):
        got = synthetic_tokens(t[:64], 513, vocab)
        assert got.is_cuda
        assert torch.equal(got.cpu(),
                           synthetic_tokens(t[:64], 513, vocab, device="cpu"))


# ------------------------------------------------------------- training --
@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Lq, Lk, D, causal, window, dtype); the forward takes
    # the tensor-core route where tc_route says so, the scalar one else,
    # and the backward the wgmma route where bwd_tc_route says so
    (1, 4, 4, 256, 256, 64, True, None, torch.bfloat16),
    (1, 8, 2, 200, 300, 128, True, None, torch.bfloat16),     # GQA, ragged
    (2, 4, 4, 300, 300, 64, True, 70, torch.bfloat16),        # window
    (1, 4, 4, 100, 100, 32, True, None, torch.bfloat16),      # D 32
    (1, 2, 1, 100, 60, 64, True, None, torch.bfloat16),       # no-key rows
    (2, 2, 2, 128, 128, 32, False, None, torch.float32),
    (1, 4, 2, 70, 150, 64, True, 8, torch.float32),
    (1, 4, 4, 96, 96, 128, True, None, torch.float32),
    # chip_smoke.py's cases at smaller sizes: the training shape's D 64,
    # GQA at D 128, a window, ragged Lq < Lk
    (2, 4, 4, 1024, 1024, 64, True, None, torch.bfloat16),
    (1, 8, 2, 512, 512, 128, True, None, torch.bfloat16),
    (1, 4, 4, 1024, 1024, 64, True, 200, torch.bfloat16),
    (1, 4, 2, 250, 389, 128, True, None, torch.bfloat16),
    (1, 4, 2, 64, 64, 64, True, None, torch.bfloat16),        # one tile
    (1, 2, 2, 300, 300, 64, False, None, torch.bfloat16),     # not causal
    # the moe, vlm and encdec families' shapes, cut in length (as in the
    # forward's cases): dk and dv over every one of the 1,500 keys
    (1, 4, 4, 1500, 1500, 64, False, None, torch.bfloat16),
    (2, 4, 4, 448, 1500, 64, False, None, torch.bfloat16),
    (1, 4, 4, 1000, 300, 64, False, None, torch.bfloat16),
    (1, 14, 2, 300, 300, 128, True, None, torch.bfloat16),
    (1, 16, 8, 512, 512, 64, True, None, torch.bfloat16),
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, case):
    """The backward kernel's dq, dk, dv against the plain chunked backward
    on the same CUDA tensors and the same forward output.  Tolerance per
    element: bf16 2^-7 |want| + 2^-10 max |want| (one bf16 rounding of
    each gradient; f32 summation order over up to Lq terms near 0); f32
    1e-5 of max |want| (summation order).  The autograd Function counts
    one backward call, on the route bwd_tc_route names, and no plain
    call."""
    B, Hq, Hkv, Lq, Lk, D, causal, window, dt = case
    g = torch.Generator().manual_seed(Lq + Lk + D)
    q = torch.randn(B, Lq, Hq, D, generator=g).to(cuda, dt).transpose(1, 2)
    k, v = (torch.randn(B, Lk, Hkv, D, generator=g).to(cuda, dt)
            .transpose(1, 2) for _ in range(2))
    do = torch.randn(B, Lq, Hq, D, generator=g).to(cuda, dt).transpose(1, 2)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    b0, t0 = flash_attention.bwd_launches, flash_attention.bwd_tc_launches
    p0 = flash_attention.plain_calls
    out = flash_attention(qg, kg, vg, causal=causal, window=window)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    assert flash_attention.bwd_launches == b0 + 1
    assert (flash_attention.bwd_tc_launches - t0
            == int(bwd_tc_route(dt, D, Lq, Lk)))
    assert flash_attention.plain_calls == p0
    want = attention_backward_chunked(q, k, v, out.detach(), do,
                                      causal=causal, window=window)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dt and a.shape == b.shape
        d, w = (a.float() - b.float()).abs(), b.float().abs()
        limit = (1e-5 * w.max() if dt == torch.float32
                 else 2.0 ** -7 * w + 2.0 ** -10 * w.max())
        assert bool((d <= limit).all()), float(d.max())


@pytest.mark.parametrize("case", [
    (1, 4, 4, 512, 512, 64, None),
    (1, 8, 2, 300, 420, 128, 100),
])
def test_flash_attention_bwd_wgmma_route_is_deterministic(cuda, case):
    """Two calls of the tensor-core backward on the same inputs give the
    same bits (no atomics: a replayed train step is bit for bit)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    B, Hq, Hkv, Lq, Lk, D, window = case
    assert bwd_tc_route(torch.bfloat16, D, Lq, Lk)
    g = torch.Generator().manual_seed(Lq * D)
    q, do = (torch.randn(B, Lq, Hq, D, generator=g).to(cuda, torch.bfloat16)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn(B, Lk, Hkv, D, generator=g).to(cuda, torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    lse = torch.empty(B, Hq, Lq, dtype=torch.float32, device=cuda)
    o, _ = flash_attention_kernel(q, k, v, window=window, lse=lse)
    first, tc = flash_attention_bwd_kernel(q, k, v, o, do, lse,
                                           window=window)
    second, tc_again = flash_attention_bwd_kernel(q, k, v, o, do, lse,
                                                  window=window)
    assert tc and tc_again
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_tensor_core_attention_from_a_fresh_thread(cuda):
    """The tensor-core forward and backward called from a thread that has
    made no CUDA call yet, as autograd's backward thread calls
    FlashAttention.backward: the driver encodes the TMA maps only with a
    context current in the calling thread, which the launchers make
    current.  Same bits as the same calls from this thread."""
    import threading
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(1, 256, 4, 64, generator=g)
                   .to(cuda, torch.bfloat16).transpose(1, 2)
                   for _ in range(4))

    def both(into):
        lse = torch.empty(1, 4, 256, dtype=torch.float32, device=cuda)
        o, tc = flash_attention_kernel(q, k, v, lse=lse)
        grads, bwd_tc = flash_attention_bwd_kernel(q, k, v, o, do, lse)
        into.update(o=o, tc=tc and bwd_tc, grads=grads)

    fresh = {}

    def run():
        try:
            both(fresh)
        except Exception as e:       # raised in the test's thread below
            fresh["error"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    assert "error" not in fresh, fresh.get("error")
    here = {}
    both(here)
    torch.cuda.synchronize()
    assert fresh["tc"] and here["tc"]
    assert torch.equal(fresh["o"], here["o"])
    for a, b in zip(fresh["grads"], here["grads"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,H,L,P,N,bc", [
    (2, 3, 100, 16, 16, torch.bfloat16),
    (1, 8, 300, 64, 64, torch.bfloat16),
    (1, 4, 130, 64, 128, torch.float32),
    (2, 12, 256, 64, 64, torch.bfloat16),    # two head groups
    (1, 16, 64, 32, 32, torch.float32),      # one chunk
])
def test_ssd_scan_backward_on_gpu_matches_plain(cuda, b, H, L, P, N, bc):
    """The scan's backward kernel on the card against its plain version
    (three chunked scans) on the same tensors, B/C one head [b, 1, L, N]
    shared by all, the model's form.  Tolerance 1e-4 of each gradient's
    max (f32 summation orders).  The autograd Function counts one backward
    call and no plain call."""
    g = torch.Generator().manual_seed(L + N)
    dt = torch.nn.functional.softplus(torch.randn(b, L, H, generator=g))
    xt = (torch.randn(b, L, H, P, generator=g) * dt[..., None]).to(
        cuda).transpose(1, 2)
    loga = (-dt).to(cuda).transpose(1, 2)
    Bm, Cm = ((torch.randn(b, L, N, generator=g) * 0.3).to(cuda, bc)
              for _ in range(2))
    dy = torch.randn(b, L, H, P, generator=g).to(cuda).transpose(1, 2)
    ins = [t.detach().requires_grad_() for t in (xt, loga, Bm, Cm)]
    b0, p0 = ssd_scan.bwd_calls, ssd_scan.plain_calls
    y = ssd_scan(ins[0], ins[1], ins[2][:, None], ins[3][:, None])
    got = torch.autograd.grad(y, ins, dy)
    assert ssd_scan.bwd_calls == b0 + 1
    assert ssd_scan.plain_calls == p0
    want = ssd_scan_backward_ref(xt, loga, Bm[:, None], Cm[:, None],
                                 y.detach(), dy)
    want = (*want[:2], want[2][:, 0].to(bc), want[3][:, 0].to(bc))
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max() / w.float().abs().max())
        assert err < (1e-4 if a.dtype == torch.float32 else 1e-2), err


@pytest.mark.parametrize("shape", ["per_head", "expanded", "one_group"])
def test_ssd_scan_bwd_kernel_matches_plain(cuda, shape):
    """The backward kernel alone against ssd_scan_backward_ref in f32, with
    B/C per head [b, H, L, N], a stride-0 expand of one group (per-head
    gradients, as the plain version gives) and one group [b, 1, L, N]
    (gradients summed over the heads); L = 200 ends in a ragged chunk.
    Tolerance 1e-4 of each gradient's max."""
    b, H, L, P, N = 2, 10, 200, 32, 64
    g = torch.Generator().manual_seed(7)
    xt = torch.randn(b, H, L, P, generator=g).to(cuda)
    loga = (-torch.rand(b, H, L, generator=g) * 0.5).to(cuda)
    hb = H if shape == "per_head" else 1
    Bm, Cm = ((torch.randn(b, hb, L, N, generator=g) * 0.3).to(cuda)
              for _ in range(2))
    if shape == "expanded":
        Bm, Cm = Bm.expand(b, H, L, N), Cm.expand(b, H, L, N)
    y = ssd_chunked_ref(xt, loga, Bm.expand(b, H, L, N),
                        Cm.expand(b, H, L, N))
    dy = torch.randn(b, H, L, P, generator=g).to(cuda)
    got = ssd_scan_bwd_kernel(xt, loga, Bm, Cm, y, dy)
    want = ssd_scan_backward_ref(xt, loga, Bm, Cm, y, dy)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        err = float((a - w).abs().max() / w.abs().max())
        assert err < 1e-4, err


def test_ssd_scan_bwd_kernel_is_deterministic(cuda):
    """Two calls of the backward kernel give the same bits (no atomics)."""
    b, H, L, P, N = 1, 12, 333, 64, 64
    g = torch.Generator().manual_seed(8)
    xt = torch.randn(b, H, L, P, generator=g).to(cuda)
    loga = (-torch.rand(b, H, L, generator=g)).to(cuda)
    Bm, Cm = ((torch.randn(b, 1, L, N, generator=g) * 0.3).to(
        cuda, torch.bfloat16) for _ in range(2))
    y = torch.randn(b, H, L, P, generator=g).to(cuda)
    dy = torch.randn(b, H, L, P, generator=g).to(cuda)
    first = ssd_scan_bwd_kernel(xt, loga, Bm, Cm, y, dy)
    second = ssd_scan_bwd_kernel(xt, loga, Bm, Cm, y, dy)
    for a, w in zip(first, second):
        assert torch.equal(a, w)


def test_train_step_on_gpu_matches_cpu(cuda):
    """One f32 train step of reduced zamba2 at head dim 64 on the card
    (both kernels forward and backward) against the same step on the CPU:
    loss within 1e-4, each gradient-driven moment within 1e-3 relative
    (Frobenius), with TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import adamw_init, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("zamba2_1p2b").reduced(head_dim=64)
    model = build_model(cfg)
    params = _to_f32(model.init_params(0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 129)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(model, num_microbatches=2)
    f0, b0 = flash_attention.launches, flash_attention.bwd_launches
    s0, sb0 = ssd_scan.launches, ssd_scan.bwd_calls
    _, gopt, gm = step(_to(params, cuda), adamw_init(_to(params, cuda)),
                       _to(batch, cuda))
    n_attn = cfg.n_layers // cfg.attn_every
    assert flash_attention.bwd_launches - b0 == 2 * n_attn
    assert flash_attention.launches - f0 == 2 * 2 * n_attn    # remat
    assert ssd_scan.bwd_calls - sb0 == 2 * cfg.n_layers
    assert ssd_scan.launches - s0 == 2 * 2 * cfg.n_layers
    _, copt, cm = step(params, adamw_init(params), batch)
    assert abs(float(gm["loss"]) - float(cm["loss"])) < 1e-4
    for a, b in zip(_flat(gopt.m), _flat(copt.m)):
        rel = float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
        assert rel < 1e-3, rel


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_wavecheck_run_all_on_gpu(cuda):
    """wavecheck at the reference's shape on the card: every program
    within its budget, held in place, rebuild-free the second time, each
    wave program's step launching its discipline's scan once, and the 8
    narrower-wave programs equal to their replay on the CPU."""
    from repro_torch.analysis import run_all
    rep = run_all(device="cuda", n_shards=8)
    assert rep["passed"], rep["violations"]
    progs = rep["programs"]
    assert len(progs) == 35
    scan = {"queue": "queue_scan", "stack": "stack_scan",
            "priority": "tiered_queue_scan", "seap": "tiered_queue_scan"}
    for kind, kernel in scan.items():
        launches = progs[f"{kind}.step"]["launches"]
        assert launches[kernel] == 1, (kind, launches)
        assert sum(launches.values()) == 1, (kind, launches)
        burst = progs[f"{kind}.run_waves[pipe]"]["launches"]
        assert burst[kernel] == rep["sizes"]["K"], (kind, burst)
    replayed = {n: p["cpu_replay"] for n, p in progs.items()
                if "cpu_replay" in p}
    assert len(replayed) == 8 and set(replayed.values()) == {"equal"}, \
        replayed


@pytest.mark.parametrize("kind", ["queue", "stack", "priority", "seap"])
def test_state_held_in_place_after_pipelined_burst_on_gpu(cuda, kind):
    """The store tensors of every discipline's state keep their storage
    through a pipelined burst on the card (the port's donation)."""
    from repro_torch.analysis.programs import STORE_FIELDS
    n_sh, L, K = 8, 16, 4
    make = {"queue": lambda: DeviceQueue(n_sh, cap=64, payload_width=2,
                                         ops_per_shard=L, device="cuda"),
            "stack": lambda: DeviceStack(n_sh, cap=64, payload_width=2,
                                         ops_per_shard=L, device="cuda"),
            "priority": lambda: DevicePriorityQueue(
                n_sh, n_prios=3, cap=64, payload_width=2, ops_per_shard=L,
                relaxation=1, device="cuda"),
            "seap": lambda: DeviceSeapQueue(n_sh, n_buckets=4, cap=64,
                                            payload_width=2,
                                            ops_per_shard=L, device="cuda")}
    q = make[kind]()
    state = q.init_state()
    before = {f: getattr(state, f).untyped_storage().data_ptr()
              for f in STORE_FIELDS[kind]}
    rng = np.random.default_rng(7)
    n = n_sh * L
    ops = [rng.random((K, n)) < 0.6, rng.random((K, n)) < 0.9]
    if kind in ("priority", "seap"):
        ops.append(rng.integers(0, 3, (K, n)).astype(np.int32))
    ops.append(rng.integers(0, 99, (K, n, 2)).astype(np.int32))
    state = q.run_waves(state, *(torch.from_numpy(x).cuda() for x in ops))[0]
    after = {f: getattr(state, f).untyped_storage().data_ptr()
             for f in STORE_FIELDS[kind]}
    assert after == before, (kind, before, after)
