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
import numpy as np
import pytest
import torch

from repro_torch.dqueue import (DevicePriorityQueue, DeviceQueue,
                                DeviceStack, ElasticDeviceQueue)
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import tc_route
from repro_torch.kernels.hash_route import hash_route, hash_route_ref
from repro_torch.kernels.segscan import (queue_scan, queue_scan_ref,
                                         stack_scan, stack_scan_ref,
                                         tiered_queue_scan,
                                         tiered_queue_scan_ref)
from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_scan

pytestmark = pytest.mark.gpu

# test_model_on_gpu_matches_cpu's tolerance on logits, per case, about
# twice the largest reading on an NVIDIA H100 80GB HBM3 at 700 W (the test
# prints them; run with -s): zamba2 0.0088, mamba2 0.0039, llama3 0.0042;
# at head dim 64 (the tensor-core flash route) zamba2 0.0068, llama3
# 0.0098
GPU_CPU_LOGIT_TOL = {"zamba2_1p2b": 0.02, "mamba2_130m": 0.01,
                     "llama3_8b": 0.01, "zamba2_1p2b-d64": 0.02,
                     "llama3_8b-d64": 0.02}


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
              "ssm": 0, "dense": cfg.n_layers}[cfg.family]
    n_ssd = 0 if cfg.family == "dense" else cfg.n_layers
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
