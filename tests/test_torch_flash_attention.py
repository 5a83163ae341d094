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

import jax
import jax.numpy as jnp
from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_backward_chunked,
                                                 attention_chunked,
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


# ------------------------------------------------------------- backward ----
BWD_CASES = [
    # (B, Hq, Hkv, Lq, Lk, D, causal, window)
    (2, 4, 4, 128, 128, 64, True, None),          # causal
    (1, 4, 4, 200, 200, 32, True, 48),            # sliding window
    (1, 8, 2, 96, 96, 64, True, None),            # GQA
    (1, 4, 2, 70, 150, 32, True, 64),             # ragged Lq < Lk, GQA
    (2, 2, 2, 64, 64, 32, False, None),           # no mask
    (1, 2, 1, 40, 24, 32, True, None),            # rows that see no key
]


def _j_vjp(q, k, v, do, causal, window):
    _, f = jax.vjp(lambda q, k, v: _j_oracle(q, k, v, causal, window),
                   q, k, v)
    return f(do)


def _no_key_rows(Lq, Lk, causal):
    """Rows (queries aligned to the end of the keys) that see no key."""
    return (np.arange(Lq) + (Lk - Lq) < 0) if causal else np.zeros(Lq, bool)


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_jax_vjp(case):
    """The chunked plain backward (f32) against ``jax.vjp`` of the JAX
    oracle, max abs error under 2e-5 of each gradient's max (summation
    order).  The oracle averages v over a row that sees no key where the
    port gives 0, so those rows' cotangent is zeroed for the comparison;
    that they contribute nothing to the port's gradients is checked
    separately."""
    B, Hq, Hkv, Lq, Lk, D, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    arr = [rng.standard_normal(s).astype(np.float32) for s in
           ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D),
            (B, Hq, Lq, D))]
    dead = _no_key_rows(Lq, Lk, causal)
    do_live = arr[3] * ~dead[None, None, :, None]
    want = _j_vjp(*(jnp.asarray(a) for a in arr[:3]), jnp.asarray(do_live),
                  causal, window)
    q, k, v, do = (torch.from_numpy(a) for a in arr)
    o = attention_chunked(q, k, v, causal=causal, window=window)
    for chunk in (32, 512):
        got = attention_backward_chunked(q, k, v, o, torch.from_numpy(
            do_live), causal=causal, window=window, chunk=chunk)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == torch.float32
            assert _err(g.numpy(), w) <= 2e-5 * np.abs(w).max()
    if dead.any():
        full = attention_backward_chunked(q, k, v, o, do, causal=causal,
                                          window=window)
        for a, b in zip(full, got):
            assert torch.equal(a, b)


def test_plain_backward_bf16_matches_jax_vjp():
    """bf16 inputs: both compute in f32 and round each gradient to bf16
    once, so they sit one bf16 step (2^-7 of |want|) apart, plus the f32
    summation orders' difference (1e-4 of the max).  The port takes
    rowsum(dO ∘ O) from the output it is given: here the f32 output, as
    JAX's exact gradient has it (with a bf16-rounded output the rows'
    sums move by a bf16 rounding).  One kv head a query head: the JAX
    side's GQA fold (``jnp.repeat`` of bf16 k, v) would add a bf16 sum."""
    B, H, L, D = 1, 4, 128, 64
    rng = np.random.default_rng(5)
    arr = [jnp.asarray(rng.standard_normal((B, H, L, D)), jnp.bfloat16)
           for _ in range(4)]
    want = _j_vjp(*arr, True, None)
    q, k, v, do = (params_from_jax(a, "cpu") for a in arr)
    o = torch.from_numpy(np.array(_j_oracle(
        *(a.astype(jnp.float32) for a in arr[:3]), True, None)))
    got = attention_backward_chunked(q, k, v, o, do, causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w).astype(np.float32)
        d = np.abs(g.float().numpy() - w)
        assert (d <= 2.0 ** -7 * np.abs(w) + 1e-4 * np.abs(w).max()).all()


@pytest.mark.parametrize("case", [
    (1, 4, 2, 5, 7, 8, True, None),
    (2, 2, 2, 6, 6, 8, True, 3),
    (1, 2, 2, 4, 9, 4, False, None),
    (1, 2, 1, 6, 4, 4, True, None),               # rows that see no key
])
def test_function_gradcheck_float64(case):
    """The autograd Function (its CPU path: the chunked forward and the
    chunked backward) passes torch.autograd.gradcheck in float64."""
    B, Hq, Hkv, Lq, Lk, D, causal, window = case
    g = torch.Generator().manual_seed(Lq * Lk)
    q, k, v = (torch.randn(B, H, L, D, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for H, L in ((Hq, Lq), (Hkv, Lk), (Hkv, Lk)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window),
        (q, k, v))


@pytest.mark.parametrize("window", [None, 5])
def test_function_matches_autograd_through_the_oracle(window):
    """The wrapper's gradients (through the Function) against autograd
    through the port's full-matrix oracle, head by head (GQA: a kv head's
    gradient sums its query heads)."""
    B, Hq, Hkv, Lq, Lk, D = 2, 4, 2, 12, 16, 8
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(B, H, L, D, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for H, L in ((Hq, Lq), (Hkv, Lk), (Hkv, Lk)))
    do = torch.randn(B, Hq, Lq, D, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(flash_attention(q, k, v, window=window),
                              (q, k, v), do)
    G = Hq // Hkv
    out = torch.stack([attention_ref(q[:, h], k[:, h // G], v[:, h // G],
                                     causal=True, window=window)
                       for h in range(Hq)], 1)
    want = torch.autograd.grad(out, (q, k, v), do)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-12


def test_no_grad_call_is_the_forward_alone():
    """Without a gradient to take the wrapper runs the plain forward once
    (on the card: the one forward launch, no log-sum-exp)."""
    q = torch.randn(1, 2, 8, 32)
    n = flash_attention.plain_calls
    flash_attention(q, q, q)
    assert flash_attention.plain_calls == n + 1
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, q, q)
    assert out.grad_fn is not None and flash_attention.plain_calls == n + 2
    out.sum().backward()
    assert flash_attention.plain_calls == n + 3


def _bwd_kernel_emulation(q, k, v, o, do, causal, window, split=True):
    """flash_attention_bwd.cu's bf16 arithmetic on the CPU (both routes;
    the tensor-core route's order of work: dk/dv over key tiles, dq over
    query tiles, each a sum of f32 products, no cross-block sum): P from
    the row's log-sum-exp in f32 as the kernels compute it,
    exp2(s·(scale·log2 e) - lse·log2 e), P and dS entering their products
    as bf16(x) + bf16(x - bf16(x)), products of bf16 values summed in f32,
    each gradient rounded to bf16 once.  split=False: one bf16 part each
    (FlashAttention-3's form), for the comparison."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf, dof, of = q.float(), do.float(), o.float()
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    s = qf @ kf.transpose(-1, -2)
    qpos = torch.arange(Lq)[:, None] + (Lk - Lq)
    kpos = torch.arange(Lk)[None]
    keep = torch.ones(Lq, Lk, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    lse = torch.logsumexp((s * scale).masked_fill(~keep, -math.inf), -1,
                          keepdim=True)
    p = torch.where(keep, torch.exp2(s * (scale * log2e) - lse * log2e),
                    0.0)

    def parts(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float() if split else 0.0 * hi
    dsum = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - dsum)
    ph, pl = parts(p)
    dh, dl = parts(ds)
    dv = ph.transpose(-1, -2) @ dof + pl.transpose(-1, -2) @ dof
    dk = (dh.transpose(-1, -2) @ qf + dl.transpose(-1, -2) @ qf) * scale
    dq = (dh @ kf + dl @ kf) * scale

    def fold(t):
        return t.reshape(B, Hkv, G, Lk, D).sum(2)
    return dq.bfloat16(), fold(dk).bfloat16(), fold(dv).bfloat16()


@pytest.mark.parametrize("case", [
    (1, 4, 4, 512, 512, 64, None),
    (1, 8, 2, 300, 400, 128, None),
    (1, 4, 4, 512, 512, 32, 100),
    (1, 2, 2, 1024, 1024, 64, None),              # the training shape's D
    (1, 2, 2, 2048, 2048, 64, None),
])
def test_backward_kernel_arithmetic_within_the_card_limit(case):
    """The backward kernel's split P and dS, emulated on the CPU, stay
    within the per-element limit chip_smoke.py holds the kernel to against
    its plain version: |d| <= 2^-7 |want| + 2^-10 max |want| (one bf16
    rounding of each gradient, plus the f32 summation orders' difference
    over up to Lq terms, which shows where |want| is near 0).  Prints the
    share of the limit used (-s), beside the share P and dS as one bf16
    part each would use."""
    B, Hq, Hkv, Lq, Lk, D, window = case
    g = torch.Generator().manual_seed(Lq + D)
    q, do = (torch.randn(B, Hq, Lq, D, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, Lk, D, generator=g).bfloat16()
            for _ in range(2))
    o = attention_chunked(q, k, v, causal=True, window=window)
    want = attention_backward_chunked(q, k, v, o, do, causal=True,
                                      window=window)
    got = _bwd_kernel_emulation(q, k, v, o, do, True, window)
    single = _bwd_kernel_emulation(q, k, v, o, do, True, window,
                                   split=False)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, single):
        d, w = (a.float() - b.float()).abs(), b.float().abs()
        limit = 2.0 ** -7 * w + 2.0 ** -10 * w.max()
        share = float((d / limit).max())
        one = float(((c.float() - b.float()).abs() / limit).max())
        print(f"{case} {name}: share of the limit {share} (one bf16 part "
              f"each: {one})")
        assert share <= 1.0
