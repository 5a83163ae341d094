"""The port's SSD scan (plain versions, on CPU tensors) against the JAX
reference.

The same numpy inputs go through ``repro.kernels.ssd_scan``'s Pallas
kernel in interpret mode and its per-token ``ssd_scan_ref``, and through
the port's ``ssd_scan`` wrapper (the chunked plain version on a CPU
tensor) and its own per-token recurrence.  The port takes the model's
``[b, H, L, ...]`` form: the reference's ``[BH, L, ...]`` inputs go in as
``b = 1``.  Tolerance as the reference
file's: max abs error below 2e-5 of max |y| (f32, summation order only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro.kernels.ssd_scan import ssd_scan_ref as j_ssd_scan_ref

from repro_torch.interop import params_from_jax
from repro_torch.kernels.ssd_scan import (ssd_chunk_parallel_ref,
                                          ssd_chunked_ref, ssd_scan,
                                          ssd_scan_ref)

REL = 2e-5


def _inputs(BH, L, P, N, seed, bc_dtype=np.float32):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((BH, L, P)).astype(np.float32)
    loga = (-np.abs(rng.standard_normal((BH, L))) * 0.1).astype(np.float32)
    B = (rng.standard_normal((BH, L, N)) * 0.3).astype(bc_dtype)
    C = (rng.standard_normal((BH, L, N)) * 0.3).astype(bc_dtype)
    return xt, loga, B, C


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.mark.parametrize("shape", [(2, 256, 64, 64, 128), (4, 128, 64, 128, 64),
                                   (1, 512, 32, 64, 128), (2, 128, 64, 64, 32)])
def test_ssd_plain_matches_jax(shape):
    BH, L, P, N, chunk = shape
    arrs = _inputs(BH, L, P, N, sum(shape))
    j_in = [jnp.asarray(a) for a in arrs]
    t_in = [torch.from_numpy(a)[None] for a in arrs]
    j_kernel = ssd_scan_pallas(*j_in, chunk=chunk, interpret=True)
    j_rec = j_ssd_scan_ref(*j_in)
    got = ssd_scan(*t_in)
    assert got.dtype == torch.float32 and got.shape == (1, BH, L, P)
    assert _rel(got[0].numpy(), j_kernel) < REL
    assert _rel(got[0].numpy(), j_rec) < REL
    assert _rel(ssd_chunked_ref(*t_in, chunk=chunk)[0].numpy(), j_kernel) < REL
    if L <= 256:      # the per-token oracle is one Python step per token
        assert _rel(ssd_scan_ref(*t_in)[0].numpy(), j_rec) < REL


@pytest.mark.parametrize("L", [1, 65, 100, 191])
def test_ssd_shared_bc_stride0_and_ragged(L):
    """The model's form: xt [b, H, L, P] and B/C [b, L, N] in bf16 shared by
    all heads as a stride-0 expand, L no chunk multiple.  Against the JAX
    oracle on the materialized [BH, L, N] copies."""
    b, H, P, N = 2, 3, 16, 16
    rng = np.random.default_rng(L)
    xt = rng.standard_normal((b, H, L, P)).astype(np.float32)
    loga = (-np.abs(rng.standard_normal((b, H, L))) * 0.1).astype(np.float32)
    Bj = jnp.array(rng.standard_normal((b, L, N)) * 0.3, jnp.bfloat16)
    Cj = jnp.array(rng.standard_normal((b, L, N)) * 0.3, jnp.bfloat16)
    Bt, Ct = (params_from_jax(x, "cpu")[:, None].expand(b, H, L, N)
              for x in (Bj, Cj))
    assert Bt.stride(1) == 0
    got = ssd_scan(torch.from_numpy(xt), torch.from_numpy(loga), Bt, Ct)
    assert got.shape == (b, H, L, P)

    def flat(x):
        return jnp.broadcast_to(x[:, None], (b, H, L, N)).reshape(b * H, L, N)
    want = j_ssd_scan_ref(jnp.asarray(xt.reshape(b * H, L, P)),
                          jnp.asarray(loga.reshape(b * H, L)), flat(Bj),
                          flat(Cj)).reshape(b, H, L, P)
    assert _rel(got.numpy(), want) < REL
    rec = ssd_scan_ref(torch.from_numpy(xt), torch.from_numpy(loga), Bt, Ct)
    assert _rel(rec.numpy(), want) < REL


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("L,N", [(1000, 64), (256, 128)])
def test_three_pass_decomposition_matches_jax(L, N, chunk):
    """The CUDA kernel's three passes written in plain PyTorch (chunk
    states, state passing, outputs) against the JAX per-token oracle and
    the JAX model's own chunked scan (``repro/models/ssm.py:_ssd_chunked``)
    in the model's form: B/C in bf16 shared by all heads, L = 1000 no chunk
    multiple, N = 128 mamba2-130m's state.  Tolerance 1e-4 of max |y|, as
    on the card."""
    b, H, P = 2, 3, 32
    rng = np.random.default_rng(L + N + chunk)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(np.float32)
    xt = (rng.standard_normal((b, L, H, P)) * dt[..., None]).astype(
        np.float32)
    loga = -dt
    Bj = jnp.array(rng.standard_normal((b, L, 1, N)) * 0.3, jnp.bfloat16)
    Cj = jnp.array(rng.standard_normal((b, L, 1, N)) * 0.3, jnp.bfloat16)
    Bt, Ct = (params_from_jax(x, "cpu")[:, :, 0][:, None].expand(b, H, L, N)
              for x in (Bj, Cj))
    got = ssd_chunk_parallel_ref(torch.from_numpy(xt).transpose(1, 2),
                                 torch.from_numpy(loga).transpose(1, 2), Bt,
                                 Ct, chunk=chunk).transpose(1, 2)
    assert got.shape == (b, L, H, P) and got.dtype == torch.float32
    want, _ = j_ssd_chunked(jnp.asarray(xt), jnp.asarray(loga), Bj, Cj)
    assert _rel(got.numpy(), want) < 1e-4

    def flat(x):
        return jnp.broadcast_to(x[:, None, :, 0], (b, H, L, N)).reshape(
            b * H, L, N)
    oracle = j_ssd_scan_ref(
        jnp.asarray(xt.transpose(0, 2, 1, 3).reshape(b * H, L, P)),
        jnp.asarray(loga.transpose(0, 2, 1).reshape(b * H, L)), flat(Bj),
        flat(Cj)).reshape(b, H, L, P).transpose(0, 2, 1, 3)
    assert _rel(got.numpy(), oracle) < 1e-4
