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
