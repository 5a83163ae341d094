"""The port's flash attention (plain version, on CPU tensors) against the
JAX reference.

The same numpy inputs go through ``repro.kernels.flash_attention``'s
Pallas kernel in interpret mode and its ``attention_ref``, and through the
port's ``flash_attention`` wrapper (which runs the query-chunked plain
version on a CPU tensor) and its ``attention_ref``.  bf16 inputs cross
bit for bit.  Tolerances are the reference file's (``tests/
test_kernels.py``): max abs error below 10 x rtol, with rtol 2e-5 in f32
(summation order only) and 2e-2 in bf16 (one rounding of the output).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import tc_route

CASES = [
    # (B, Hq, Hkv, Lq, Lk, D, causal, window, dtype, rtol)
    (2, 4, 4, 128, 128, 64, True, None, jnp.float32, 2e-5),
    (1, 8, 2, 128, 256, 64, True, None, jnp.float32, 2e-5),   # GQA + align
    (1, 4, 4, 256, 256, 128, True, 128, jnp.float32, 2e-5),   # SWA
    (2, 2, 2, 128, 128, 64, False, None, jnp.float32, 2e-5),  # encoder
    (1, 4, 4, 128, 128, 64, True, None, jnp.bfloat16, 2e-2),
    (1, 2, 2, 384, 384, 64, True, 256, jnp.float32, 2e-5),    # non-pow2 seq
]


def _qkv(case, seed):
    B, Hq, Hkv, Lq, Lk, D, _, _, dtype, _ = case
    rng = np.random.default_rng(seed)
    q = jnp.array(rng.standard_normal((B, Hq, Lq, D)), dtype)
    k = jnp.array(rng.standard_normal((B, Hkv, Lk, D)), dtype)
    v = jnp.array(rng.standard_normal((B, Hkv, Lk, D)), dtype)
    return (q, k, v), [params_from_jax(x, "cpu") for x in (q, k, v)]


def _j_oracle(q, k, v, causal, window):
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = jnp.repeat(k, G, axis=1).reshape(B * Hq, Lk, D)
    vr = jnp.repeat(v, G, axis=1).reshape(B * Hq, Lk, D)
    return j_attention_ref(q.reshape(B * Hq, Lq, D), kr, vr, causal=causal,
                           window=window).reshape(B, Hq, Lq, D)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                                - np.asarray(b, np.float32))))


@pytest.mark.parametrize("chunk", [64, 512])
@pytest.mark.parametrize("case", CASES)
def test_plain_flash_matches_jax_kernel_and_oracle(case, chunk):
    causal, window, rtol = case[6], case[7], case[9]
    (q, k, v), (tq, tk, tv) = _qkv(case, sum(case[:6]))
    got = attention_chunked(tq, tk, tv, causal=causal, window=window,
                            chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    j_kernel = j_flash(q, k, v, causal=causal, window=window,
                       interpret=True)
    assert _err(got, j_kernel) < rtol * 10
    assert _err(got, _j_oracle(q, k, v, causal, window)) < rtol * 10


@pytest.mark.parametrize("case", [
    (1, 4, 2, 200, 200, 32, True, None, jnp.float32, 2e-5),   # ragged
    (2, 4, 4, 77, 300, 64, True, 50, jnp.float32, 2e-5),      # ragged+SWA
    (1, 2, 1, 1, 130, 64, True, 16, jnp.bfloat16, 2e-2),      # decode row
])
def test_plain_flash_ragged_matches_jax_oracle(case):
    """Lengths that are no block multiple (the Pallas kernel asserts them
    away; the port's wrapper takes them) against the JAX oracle."""
    causal, window, rtol = case[6], case[7], case[9]
    (q, k, v), (tq, tk, tv) = _qkv(case, 11 + case[3])
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert _err(got.float().numpy(), _j_oracle(q, k, v, causal, window)) \
        < rtol * 10


@pytest.mark.parametrize("window", [None, 3])
def test_port_oracle_matches_jax_oracle(window):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, L, 32)).astype(np.float32)
               for L in (9, 20, 20))
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=True, window=window)
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window)
    assert _err(got.numpy(), want) < 2e-5 * 10


def test_rows_that_see_no_key_are_zero():
    """More queries than keys: the first rows see no key and give 0 (the
    kernel's ``l == 0`` rule); the rest match the oracle."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 1, 10, 32)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, 4, 32)).astype(
        np.float32)) for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    assert torch.equal(got[0, 0, :6], torch.zeros(6, 32))
    want = attention_ref(q[0], k[0], v[0], causal=True)
    assert float((got[0, 0, 6:] - want[0, 6:]).abs().max()) < 2e-4


def _tensor_core_emulation(q, k, v, causal, window, split=True, bk=64):
    """flash_fwd_wgmma's arithmetic on the CPU: S = Q·Kᵀ from bf16 values
    summed in f32, the online softmax over 64-key tiles in exp2 with the
    scale folded into the argument, P·V from p_hi = bf16(p) plus, with
    ``split``, p_lo = bf16(p - p_hi), each product summed in f32; the
    output rounded to bf16 once."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, 1)
    vf = v.float().repeat_interleave(Hq // Hkv, 1)
    sl2 = D ** -0.5 * math.log2(math.e)
    qpos = torch.arange(Lq) + (Lk - Lq)
    m = torch.full((B, Hq, Lq), -math.inf)
    l = torch.zeros(B, Hq, Lq)
    o = torch.zeros(B, Hq, Lq, D)
    for k0 in range(0, Lk, bk):
        kpos = torch.arange(k0, min(k0 + bk, Lk))
        s = q.float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        keep = torch.ones(Lq, kpos.shape[0], dtype=torch.bool)
        if causal:
            keep &= kpos[None] <= qpos[:, None]
        if window is not None:
            keep &= kpos[None] > qpos[:, None] - window
        s = s.masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new * sl2)
        alpha = torch.exp2(m * sl2 - base)
        p = torch.exp2(s * sl2 - base[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + bk]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
        o = o * alpha[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] > 0, o / l[..., None].clamp(min=1e-30),
                      0.0)
    return out.bfloat16()


def _share_of_limit(got, want) -> float:
    """Largest share of the card's per-element limit, |got - want| <=
    2^-7 |want| + 1e-5, that got uses (chip_smoke.py's FLASH_RTOL,
    FLASH_ATOL)."""
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    return float((d / (2.0 ** -7 * w + 1e-5)).max())


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Lq, Lk, D, window)
    (1, 2, 2, 2048, 2048, 64, None),
    (1, 4, 2, 1000, 1500, 128, None),
    (1, 2, 2, 1024, 1024, 64, 100),
])
def test_tensor_core_split_p_arithmetic_within_the_card_limit(case):
    """The tensor-core kernel keeps P near f32 as p_hi + p_lo; emulated on
    the CPU it stays within the per-element limit of the plain f32 version
    that chip_smoke.py holds the kernel to.  Prints the share of the limit
    it uses beside the share a single bf16 P uses (run with -s)."""
    B, Hq, Hkv, Lq, Lk, D, window = case
    g = torch.Generator().manual_seed(Lq + D)
    q = torch.randn(B, Hq, Lq, D, generator=g).bfloat16()
    k, v = (torch.randn(B, Hkv, Lk, D, generator=g).bfloat16()
            for _ in range(2))
    want = attention_chunked(q, k, v, causal=True, window=window)
    split = _share_of_limit(
        _tensor_core_emulation(q, k, v, True, window), want)
    single = _share_of_limit(
        _tensor_core_emulation(q, k, v, True, window, split=False), want)
    print(f"{case}: share of the limit, p_hi + p_lo {split}, "
          f"single bf16 P {single}")
    assert split <= 1.0


@pytest.mark.parametrize("dtype,D,Lq,tc", [
    (torch.bfloat16, 64, 4096, True),     # the prefill's calls
    (torch.bfloat16, 128, 64, True),      # llama3-8b's heads, one tile
    (torch.bfloat16, 64, 63, False),      # fewer queries than one box
    (torch.bfloat16, 64, 1, False),       # a decode row
    (torch.bfloat16, 32, 4096, False),    # the reduced configs' heads
    (torch.float32, 64, 4096, False),     # the f32 prefill check
    (torch.float32, 128, 200, False),
])
def test_route_rule(dtype, D, Lq, tc):
    """bf16 with D in (64, 128) and at least 64 queries goes to the
    tensor-core kernel; everything else to the scalar one."""
    assert tc_route(dtype, D, Lq) is tc
