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

import jax
import jax.numpy as jnp
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro.kernels.ssd_scan import ssd_scan_ref as j_ssd_scan_ref

from repro_torch.interop import params_from_jax
from repro_torch.kernels.ssd_scan import (SSDScan,
                                          ssd_backward_chunk_parallel_ref,
                                          ssd_chunk_parallel_ref,
                                          ssd_chunked_ref, ssd_scan,
                                          ssd_scan_backward_ref,
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


# ------------------------------------------------------------- backward ----
def _model_inputs(b, H, L, P, N, seed, shared=True):
    """The model's form as numpy: xt [b, H, L, P], loga [b, H, L] (dt from
    a softplus), B/C [b, L, N] shared by every head (or [b, H, L, N])."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, H, L)))).astype(np.float32)
    xt = (rng.standard_normal((b, H, L, P)) * dt[..., None]).astype(
        np.float32)
    loga = (-dt * 0.5).astype(np.float32)
    bc = (b, L, N) if shared else (b, H, L, N)
    B, C = ((rng.standard_normal(bc) * 0.3).astype(np.float32)
            for _ in range(2))
    dy = rng.standard_normal((b, H, L, P)).astype(np.float32)
    return xt, loga, B, C, dy


def _j_grads(xt, loga, B, C, dy):
    """jax.vjp of the JAX model's chunked scan, ``_ssd_chunked`` (B/C one
    group shared by every head), in the port's [b, H, L, ...] layout."""
    def f(x, la, Bm, Cm):
        y, _ = j_ssd_chunked(x.transpose(0, 2, 1, 3), la.transpose(0, 2, 1),
                             Bm[:, :, None], Cm[:, :, None])
        return y.transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (xt, loga, B, C)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _t_grads(xt, loga, B, C, dy, fn=ssd_scan):
    """The port's gradients through ``fn`` with B/C [b, L, N] expanded over
    the heads (stride 0): autograd sums the per-head dB, dC."""
    b, H, L, _ = xt.shape
    N = B.shape[-1]
    ins = [torch.from_numpy(a).requires_grad_() for a in (xt, loga, B, C)]
    x, la, Bm, Cm = ins
    Bh, Ch = (m[:, None].expand(b, H, L, N) for m in (Bm, Cm))
    assert Bh.stride(1) == 0
    y = fn(x, la, Bh, Ch)
    return [g.numpy() for g in torch.autograd.grad(y, ins,
                                                   torch.from_numpy(dy))]


# the adjoint scans sum in another order than jax.grad's transpose of the
# chunked scan; dloga is a reverse cumulative sum of differences over L
BWD_REL = 1e-4


@pytest.mark.parametrize("L", [64, 100, 256])
def test_plain_backward_matches_jax_vjp(L):
    """The port's backward (three chunked scans and a reverse cumsum)
    against jax.vjp of the JAX model's chunked scan: dxt, dloga, dB, dC,
    B/C shared by the heads as a stride-0 expand, L = 100 a ragged last
    chunk.  Max abs error under 1e-4 of each gradient's max."""
    arrs = _model_inputs(2, 3, L, 16, 16, L)
    want = _j_grads(*arrs)
    got = _t_grads(*arrs)
    for name, g, w in zip(("dxt", "dloga", "dB", "dC"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < BWD_REL, (name, _rel(g, w))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("L", [7, 70])
def test_backward_matches_autograd_through_the_recurrence(L, shared):
    """ssd_scan_backward_ref against torch autograd through the per-token
    recurrence (ssd_scan_ref), float64, per-head and stride-0 B/C, L = 70
    across a chunk edge."""
    b, H, P, N = 2, 3, 16, 16
    arrs = [a.astype(np.float64) for a in _model_inputs(b, H, L, P, N, L,
                                                        shared)]
    x, la, Bg, Cg = (torch.from_numpy(a).requires_grad_() for a in arrs[:4])
    dy = torch.from_numpy(arrs[4])
    Bh, Ch = ((m[:, None].expand(b, H, L, N) for m in (Bg, Cg)) if shared
              else (Bg, Cg))
    y = ssd_scan_ref(x, la, Bh, Ch)
    want = torch.autograd.grad(y, (x, la, Bg, Cg), dy)
    got = list(ssd_scan_backward_ref(x.detach(), la.detach(), Bh.detach(),
                                     Ch.detach(), y.detach(), dy))
    if shared:                      # what autograd's expand sums
        got[2], got[3] = got[2].sum(1), got[3].sum(1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) < 1e-12


@pytest.mark.parametrize("shared", [True, False])
def test_function_gradcheck_float64(shared):
    """The autograd Function (its CPU path) passes gradcheck in float64,
    with B/C per head and as a stride-0 expand; L = 9 with a chunk of 64
    is one ragged chunk."""
    b, H, L, P, N = 1, 2, 9, 3, 2
    g = torch.Generator().manual_seed(1)

    def t(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64,
                           requires_grad=True)
    xt, loga = t(b, H, L, P), (-torch.rand(b, H, L, generator=g,
                                            dtype=torch.float64)
                               ).requires_grad_()
    if shared:
        Bm, Cm = t(b, 1, L, N), t(b, 1, L, N)
        assert torch.autograd.gradcheck(
            lambda x, la, Bm, Cm: SSDScan.apply(
                x, la, Bm.expand(b, H, L, N), Cm.expand(b, H, L, N)),
            (xt, loga, Bm, Cm))
    else:
        assert torch.autograd.gradcheck(SSDScan.apply,
                                        (xt, loga, t(b, H, L, N),
                                         t(b, H, L, N)))


def test_backward_in_bf16_bc_as_the_model_has_them():
    """B/C in bf16, one head [b, 1, L, N] shared by all (the model's form):
    the Function gives f32 dxt, dloga and bf16 dB, dC summed over the
    heads in f32, within 1e-2 of the f32 gradients of the same values (one
    bf16 rounding of each summed gradient, and B, C in bf16 in the dxt
    scan)."""
    b, H, L, P, N = 1, 4, 100, 16, 16
    xt, loga, B, C, dy = _model_inputs(b, H, L, P, N, 9)
    B16, C16 = (torch.from_numpy(m).bfloat16() for m in (B, C))
    want = _t_grads(xt, loga, B16.float().numpy(), C16.float().numpy(), dy)
    ins = [torch.from_numpy(xt).requires_grad_(),
           torch.from_numpy(loga).requires_grad_(),
           B16.requires_grad_(), C16.requires_grad_()]
    y = ssd_scan(ins[0], ins[1], ins[2][:, None], ins[3][:, None])
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), w) < 1e-2


@pytest.mark.parametrize("L", [64, 100])
def test_one_group_bc_gradients_are_summed_in_f32(L):
    """B/C as one head [b, 1, L, N]: the backward returns dB, dC of that
    shape, the per-head scans summed over the heads in f32 inside the
    backward, equal to what autograd sums through a stride-0 expand of the
    same tensors and to jax.vjp of the JAX model's chunked scan (1e-4 of
    each gradient's max, as BWD_REL)."""
    b, H, P, N = 2, 3, 16, 16
    xt, loga, B, C, dy = _model_inputs(b, H, L, P, N, L + 1)
    ins = [torch.from_numpy(a).requires_grad_() for a in (xt, loga, B, C)]
    y = ssd_scan(ins[0], ins[1], ins[2][:, None], ins[3][:, None])
    got = [g.numpy() for g in torch.autograd.grad(y, ins,
                                                  torch.from_numpy(dy))]
    through_expand = _t_grads(xt, loga, B, C, dy)
    want = _j_grads(xt, loga, B, C, dy)
    one = ssd_scan_backward_ref(*(torch.from_numpy(a) for a in (xt, loga)),
                                torch.from_numpy(B)[:, None],
                                torch.from_numpy(C)[:, None], y.detach(),
                                torch.from_numpy(dy))
    assert one[2].shape == one[3].shape == (b, 1, L, N)
    for name, g, e, w in zip(("dxt", "dloga", "dB", "dC"), got,
                             through_expand, want):
        assert g.shape == w.shape, name
        assert _rel(g, e) < 1e-6, (name, _rel(g, e))
        assert _rel(g, w) < BWD_REL, (name, _rel(g, w))


def test_function_gradcheck_float64_one_group():
    """gradcheck of the autograd Function in float64 with B/C one head
    [b, 1, L, N] shared by H = 3 heads (the backward sums over heads)."""
    b, H, L, P, N = 1, 3, 9, 3, 2
    g = torch.Generator().manual_seed(2)

    def t(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64,
                           requires_grad=True)
    loga = (-torch.rand(b, H, L, generator=g, dtype=torch.float64)
            ).requires_grad_()
    assert torch.autograd.gradcheck(
        SSDScan.apply, (t(b, H, L, P), loga, t(b, 1, L, N), t(b, 1, L, N)))


# ------------------------------------- the backward kernel's passes ----
def _chunk_parallel_grads(xt, loga, B, C, dy):
    """ssd_backward_chunk_parallel_ref and ssd_scan_backward_ref on the same
    inputs (numpy; B/C [b, L, N] one group passed as [b, 1, L, N], or
    [b, H, L, N] per head), the forward's y from the chunked scan."""
    b, H, L, _ = xt.shape
    N = B.shape[-1]
    x, la, Bt, Ct, d = (torch.from_numpy(a) for a in (xt, loga, B, C, dy))
    if Bt.dim() == 3:
        Bt, Ct = Bt[:, None], Ct[:, None]
    y = ssd_chunked_ref(x, la, Bt.expand(b, H, L, N), Ct.expand(b, H, L, N))
    got = ssd_backward_chunk_parallel_ref(x, la, Bt, Ct, y, d)
    ref = ssd_scan_backward_ref(x, la, Bt, Ct, y, d)
    return got, ref


@pytest.mark.parametrize("L", [64, 100, 200])
def test_chunk_parallel_backward_matches_jax_vjp(L):
    """The backward kernel's passes in plain PyTorch (chunk states both
    ways, the two state passes, the chunks, the cross-chunk finish) against
    jax.vjp of the JAX model's chunked scan and against
    ssd_scan_backward_ref: B/C one group [b, 1, L, N] shared by H = 10
    heads (two head groups, summed in order), L = 100 and 200 ending in a
    ragged chunk.  Max abs error under BWD_REL of each gradient's max
    against JAX, 1e-5 against the other plain backward (two f32 orders)."""
    arrs = _model_inputs(2, 10, L, 16, 16, L + 5)
    want = _j_grads(*arrs)
    got, ref = _chunk_parallel_grads(*arrs)
    for name, g, w, r in zip(("dxt", "dloga", "dB", "dC"), got, want, ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert _rel(g, r) < 1e-5, (name, _rel(g, r))
        if name in ("dB", "dC"):
            g = g[:, 0]
        assert _rel(g, w) < BWD_REL, (name, _rel(g, w))


@pytest.mark.parametrize("L", [64, 100, 200])
def test_chunk_parallel_backward_per_head_bc_matches_jax_vjp(L):
    """Per-head B/C [b, H, L, N] (per-head dB, dC): the passes against
    jax.vjp of the reference's per-token scan (its [BH, L, ...] form,
    which takes a B and C per head) and ssd_scan_backward_ref."""
    b, H, P, N = 2, 3, 16, 16
    xt, loga, B, C, dy = _model_inputs(b, H, L, P, N, L + 6, shared=False)

    def flat(a):
        return jnp.asarray(a.reshape(b * H, *a.shape[2:]))
    _, vjp = jax.vjp(j_ssd_scan_ref, *(flat(a) for a in (xt, loga, B, C)))
    want = [np.asarray(g).reshape(b, H, *g.shape[1:])
            for g in vjp(flat(dy))]
    got, ref = _chunk_parallel_grads(xt, loga, B, C, dy)
    for name, g, w, r in zip(("dxt", "dloga", "dB", "dC"), got, want, ref):
        assert g.shape == w.shape == r.shape, name
        assert _rel(g, r) < 1e-5, (name, _rel(g, r))
        assert _rel(g, w) < BWD_REL, (name, _rel(g, w))


def test_chunk_parallel_backward_bf16_bc():
    """B/C in bf16, one group, as the model passes them: the passes against
    ssd_scan_backward_ref on the same bf16 values, and against jax.vjp of
    the JAX model's chunked scan of those values in f32."""
    b, H, L, P, N = 1, 4, 100, 16, 16
    xt, loga, B, C, dy = _model_inputs(b, H, L, P, N, 19)
    B16, C16 = (torch.from_numpy(m).bfloat16() for m in (B, C))
    want = _j_grads(xt, loga, B16.float().numpy(), C16.float().numpy(), dy)
    x, la, d = (torch.from_numpy(a) for a in (xt, loga, dy))
    y = ssd_chunked_ref(x, la, B16[:, None].expand(b, H, L, N),
                        C16[:, None].expand(b, H, L, N))
    got = ssd_backward_chunk_parallel_ref(x, la, B16[:, None],
                                          C16[:, None], y, d)
    ref = ssd_scan_backward_ref(x, la, B16[:, None], C16[:, None], y, d)
    for name, g, w, r in zip(("dxt", "dloga", "dB", "dC"), got, want, ref):
        assert g.dtype == torch.float32, name
        assert _rel(g, r) < 1e-5, (name, _rel(g, r))
        if name in ("dB", "dC"):
            g = g[:, 0]
        assert _rel(g, w) < BWD_REL, (name, _rel(g, w))


class _ChunkParallelScan(torch.autograd.Function):
    """The chunked forward with the chunk-parallel backward (chunks of 4,
    so a short sequence crosses several), for gradcheck."""

    @staticmethod
    def forward(ctx, xt, loga, B, C):
        H = xt.shape[1]
        shape = (xt.shape[0], H, *B.shape[2:])
        y = ssd_chunked_ref(xt, loga, B.expand(shape), C.expand(shape),
                            chunk=4)
        ctx.save_for_backward(xt, loga, B, C, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        xt, loga, B, C, y = ctx.saved_tensors
        return ssd_backward_chunk_parallel_ref(xt, loga, B, C, y, dy,
                                               chunk=4)


@pytest.mark.parametrize("shared", [True, False])
def test_chunk_parallel_backward_gradcheck_float64(shared):
    """gradcheck in float64 of the chunked scan with the chunk-parallel
    backward: L = 11 in chunks of 4 (a ragged last chunk), 9 heads (two
    head groups), B/C one group or per head."""
    b, H, L, P, N = 1, 9, 11, 3, 2
    g = torch.Generator().manual_seed(4)

    def t(*s):
        return torch.randn(*s, generator=g, dtype=torch.float64,
                           requires_grad=True)
    loga = (-torch.rand(b, H, L, generator=g, dtype=torch.float64)
            ).requires_grad_()
    hb = 1 if shared else H
    assert torch.autograd.gradcheck(
        _ChunkParallelScan.apply,
        (t(b, H, L, P), loga, t(b, hb, L, N), t(b, hb, L, N)))
