"""The port's encoder-decoder (whisper-small, reduced) against the JAX
package on the same numbers.

JAX's ``init_params(jax.random.key(0))`` crosses to the port bit for bit
(``params_from_jax``); the same numpy frames (rounded to bf16 once, as
the reference's encoder rounds them) and tokens go through both; the port
runs on CPU tensors (the flash-attention kernels' plain versions: the
encoder's bidirectional attention and the decoder's cross-attention take
``causal=False``).

Tolerances, from readings of these tests (run with ``-s``), each about
twice its reading.  Both packages compute in bf16 with f32 reductions,
XLA keeping excess precision where torch rounds every op, so they differ
by a few bf16 roundings per layer.  Readings: encoder states 0.0056
relative (Frobenius); the decoder's hidden on the reference's encoder
states 0.0074; logits of two cached decode steps 0.0078 and 0.0059
absolute (logit std about 0.23), their cache 0.0045; |Δloss| 1.5e-4,
worst gradient leaf 0.021 (``dec_layers/lnx``, relative Frobenius; each
package's bf16 gradients are as far from the port's f32 gradients of the
same weights: JAX 0.022, the port 0.017, worst leaves).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import encdec as JED

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import build_model
from repro_torch.models import encdec as ED

ARCH = "whisper_small"
STATE_REL = 0.015
LOGIT_TOL = 0.016
CACHE_REL = 0.01
LOSS_TOL = 3e-4
GRAD_REL = 0.045


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _rel(a, b) -> float:
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b).astype(np.float32)
    return float(np.linalg.norm(a.astype(np.float32) - b)
                 / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert repr(jcfg) == repr(cfg) and cfg.family == "encdec"
    jm = j_build_model(jcfg)
    jp, _ = jm.init_params(jax.random.key(0))
    return jcfg, cfg, jm, jp, build_model(cfg), params_from_jax(jp, "cpu")


def _frames(cfg, B, seed):
    f = np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model))
    jf = jnp.asarray(f, jnp.bfloat16)
    return jf, params_from_jax(jf, "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_params_cross_bit_exact_and_init_matches_tree(pair):
    """``params_from_jax`` carries the encdec tree (``enc_layers``,
    ``dec_layers``) bit for bit, and the port's own init has its tree,
    shapes and dtypes."""
    _, _, _, jp, model, tp = pair
    back = dict(_leaves(params_to_numpy(tp)))
    mine = dict(_leaves(model.init_params(0, device="cpu")))
    jl = dict(_leaves(jp))
    assert back.keys() == jl.keys() == mine.keys()
    assert any(k.startswith("/enc_layers/") for k in jl)
    assert any(k.startswith("/dec_layers/cross_attn/") for k in jl)
    for name, a in jl.items():
        a = np.asarray(a)
        np.testing.assert_array_equal(back[name], a.view(np.uint16),
                                      err_msg=name)
        assert tuple(mine[name].shape) == a.shape, name
        assert str(mine[name].dtype).split(".")[-1] == str(a.dtype), name


def test_encode_and_decode_match_jax(pair):
    """The encoder's states, then the teacher-forced decoder's hidden on
    the reference's encoder states (so the decoder is held alone)."""
    jcfg, cfg, _, jp, _, tp = pair
    jf, tf = _frames(cfg, 2, 1)
    want = JED.encode(jp, jcfg, jf, remat=False)
    got = ED.encode(tp, cfg, tf, remat=False)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    enc_gap = _rel(got, want)
    toks = _tokens(cfg, 2, 24, 2)
    jh, _ = JED.decode(jp, jcfg, jnp.asarray(toks), want, remat=False)
    th = ED.decode(tp, cfg, torch.from_numpy(toks).long(),
                   params_from_jax(want, "cpu"), remat=False)
    dec_gap = _rel(th, jh)
    print(f"encoder states rel {enc_gap}; decoder hidden rel {dec_gap}")
    assert enc_gap < STATE_REL and dec_gap < STATE_REL


def test_cached_decode_steps_match_jax(pair):
    """Two decode steps from an empty cache against the reference's
    ``encdec_decode_step``: logits each step, then the whole cache."""
    jcfg, cfg, jm, jp, model, tp = pair
    jf, tf = _frames(cfg, 2, 3)
    jenc = JED.encode(jp, jcfg, jf, remat=False)
    tenc = model.encode(tp, tf)
    toks = _tokens(cfg, 2, 2, 4)
    jc, _ = jm.init_cache(2, 8)
    tc = model.init_cache(2, 8, device="cpu")
    assert set(tc) == set(jc) and all(tc[k].shape == jc[k].shape
                                      for k in jc)
    gaps = []
    for t in range(2):
        jl, jc = jm.decode_fn(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t), jenc)
        tl, tc = model.decode_fn(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), t, enc_out=tenc)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        gaps.append(float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    rel = {k: _rel(tc[k], jc[k]) for k in jc}
    print(f"cached decode max |Δlogit| {gaps}, cache {rel}")
    assert max(gaps) < LOGIT_TOL
    assert max(rel.values()) < CACHE_REL


def test_decode_step_needs_encoder_states(pair):
    """The reference's serving engine passes no ``enc_out``, so encdec is
    not served; a decode step without it says what it needs."""
    _, cfg, _, _, model, tp = pair
    cache = model.init_cache(1, 4, device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        model.decode_fn(tp, cache, torch.zeros(1, 1, dtype=torch.long), 0)


def _port_value_and_grad(model, params, batch):
    leaves = {n: t.detach().requires_grad_() for n, t in _leaves(params)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        return leaves[prefix]
    loss = model.loss_fn(rebuild(params), batch)
    loss.backward()
    return float(loss.detach()), {n: t.grad for n, t in leaves.items()}


def test_loss_and_grads_match_jax(pair):
    """``encdec_loss`` and its bf16 gradients against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    _, cfg, jm, jp, model, tp = pair
    jf, tf = _frames(cfg, 2, 5)
    toks = _tokens(cfg, 2, 33, 6)
    jb = {"frames": jf, "tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)
    tb = {"frames": tf, "tokens": torch.from_numpy(toks[:, :-1]),
          "targets": torch.from_numpy(toks[:, 1:])}
    loss, grads = _port_value_and_grad(model, tp, tb)
    rel = {}
    for name, g in _leaves(jg):
        assert grads[name] is not None and grads[name].dtype == torch.bfloat16
        rel[name] = _rel(grads[name], g)
    worst = max(rel, key=rel.get)
    gap = abs(loss - float(jl))
    print(f"loss {loss} vs {float(jl)}, |Δ| {gap}; worst leaf {worst} "
          f"{rel[worst]}")
    assert gap < LOSS_TOL
    assert rel[worst] < GRAD_REL, worst


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 0.15),
                                       (torch.float32, 1e-4)])
def test_prefill_equals_teacher_forced_decode(pair, dtype, tol):
    """The port's prefill (encode, then the decoder over the prompt: the
    flash-attention plain versions) against its decode steps (ring cache,
    plain cross-attention) at every position of a 40-token prompt.
    Tolerances as the decoder-only models' (``test_torch_models.py``):
    bf16 the reference's own 0.15, f32 1e-4 (summation order)."""
    _, cfg, _, _, model, tp = pair
    tp = _cast(tp, dtype)
    _, tf = _frames(cfg, 1, 7)
    toks = torch.from_numpy(_tokens(cfg, 1, 40, 8)).long()
    enc = model.encode(tp, tf)
    full = (ED.decode(tp, cfg, toks, enc, remat=False)
            @ tp["unembed"]).float()
    # the last row alone against the whole product: summation order only
    np.testing.assert_allclose(model.prefill(tp, toks, frames=tf).numpy(),
                               full[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    cache = model.init_cache(1, 40, device="cpu", dtype=dtype)
    steps = [model.decode_fn(tp, cache, toks[:, t:t + 1], t,
                             enc_out=enc)[0] for t in range(40)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)
