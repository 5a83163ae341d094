"""The port's MoE FFN and the moe family's training loss against the JAX
package on the same numbers.

Reduced granite-moe-1b (4 experts, top-2): JAX's ``init_params(jax.
random.key(0))`` crosses to the port bit for bit (``params_from_jax``);
the same numpy activations and tokens go through both; the port runs on
CPU tensors.  The reduced config is dropless (capacity factor 8, as the
reference's), so each check also runs at factors that drop choices.

Tolerances, from readings of these tests (run with ``-s``), each bound
about twice its reading:

* ``moe_ffn`` alone on the same input: the chosen experts and ranks are
  equal (so are the kept choices); y within ``Y_TOL`` of max |y| (bf16:
  the two round the expert products to bf16 at other places; f32:
  summation order), aux within ``AUX_REL``.  Readings at factors 8, 1 and
  0.5 (0, 6 and 96 of 192 choices dropped): bf16 0.0066 of max |y| at
  each, f32 2.9e-7, 7.1e-7, 2.9e-7; aux 0 in bf16, 1.2e-7 in f32.
* f32 gradients of ``moe_ffn`` against ``jax.grad`` of the reference's
  (the reference's ``loss_fn`` cannot run on f32 weights: its layer scan
  carries bf16): worst leaf 4.4e-7 (the router at factor 1).
* ``loss_fn`` in bf16 against ``jax.value_and_grad``: |Δloss| 1.2e-4 and
  3.4e-4 at factors 8 and 1; worst leaf the router, 0.115 and 0.089
  relative Frobenius error.  That is bf16's rounding, not a wrong
  gradient: each package's bf16 router gradient is as far from the
  port's f32 gradient of the same weights (JAX 0.121 and 0.108, the port
  0.140 and 0.138), and every other leaf shows the same (w1, wq and the
  embedding 0.06-0.11 each way).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import moe as JMOE

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import moe as MOE

ARCH = "granite_moe_1b"
FACTORS = [8.0, 1.0, 0.5]           # dropless (the reduced config's), drops
Y_TOL = {"bfloat16": 0.015, "float32": 1.5e-6}
AUX_REL = 1e-6
GRAD_REL = 1e-6
LOSS_TOL_BF16 = 7e-4
GRAD_REL_BF16 = 0.25


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert repr(jcfg) == repr(cfg)
    jp, _ = j_build_model(jcfg).init_params(jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


def _j_route(jp, x, cfg, factor):
    """The reference's top-k, ranks and keep mask (``moe.py:46-64``)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = int(max(1, round(S * K / E * factor)))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.float32).reshape(B, S * K, E)
    ranks = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.einsum("bte,bte->bt", ranks, flat).reshape(B, S, K)
    return np.asarray(idx), np.asarray(pos).astype(np.int64), C


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("factor", FACTORS)
def test_moe_ffn_matches_jax(pair, factor, dtype):
    jcfg, cfg, jp, tp = pair
    jl, tl = _layer0(jp), _layer0(tp)
    if dtype == "float32":
        jl = {k: v.astype(jnp.float32) for k, v in jl.items()}
        tl = {k: v.float() for k, v in tl.items()}
    B, S = 2, 48
    x_np = np.random.default_rng(1).standard_normal((B, S, cfg.d_model))
    x_j = jnp.asarray(x_np, getattr(jnp, dtype))
    x_t = params_from_jax(x_j, "cpu")
    y_j, aux_j = JMOE.moe_ffn(jl, x_j, jcfg, capacity_factor=factor)
    y_t, aux_t = MOE.moe_ffn(tl, x_t, cfg, capacity_factor=factor)
    assert y_t.dtype == x_t.dtype and y_t.shape == (B, S, cfg.d_model)
    idx_j, pos_j, C = _j_route(jl, x_j, jcfg, factor)
    _, idx_t, pos_t, C_t, _ = MOE.route(tl, x_t, cfg, factor)
    assert C_t == C
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(pos_t.numpy(), pos_j)
    dropped = int((pos_j >= C).sum())
    if factor < 8:
        assert dropped > 0, "a capacity that drops"
    else:
        assert dropped == 0
    y_j = np.asarray(y_j).astype(np.float32)
    gap = float(np.abs(y_t.float().numpy() - y_j).max() / np.abs(y_j).max())
    aux_gap = abs(float(aux_t) - float(aux_j)) / float(aux_j)
    print(f"moe_ffn {dtype} factor {factor}: {dropped} of {B * S * cfg.top_k}"
          f" choices dropped, max |Δy| / max|y| {gap}, aux {float(aux_t)} "
          f"rel gap {aux_gap}")
    assert gap < Y_TOL[dtype]
    assert aux_gap <= AUX_REL


def test_dropped_choices_contribute_nothing(pair):
    """A token whose every choice is dropped gets y = 0, and a kept
    choice's output does not depend on the dropped ones: capacity 1 keeps
    exactly the first choice of each expert in (token, choice) order."""
    _, cfg, _, tp = pair
    tl = _layer0(tp)
    x = torch.randn(1, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).bfloat16()
    factor = 1.0 / (32 * cfg.top_k / cfg.n_experts)       # C = 1
    y, _ = MOE.moe_ffn(tl, x, cfg, capacity_factor=factor)
    _, idx, pos, C, _ = MOE.route(tl, x, cfg, factor)
    assert C == 1 and int((pos < C).sum()) <= cfg.n_experts
    none_kept = ~(pos < C).any(-1)[0]
    assert bool(none_kept.any())
    assert bool((y[0, none_kept] == 0).all())


@pytest.mark.parametrize("factor", FACTORS)
def test_f32_moe_grads_match_jax(pair, factor):
    """Gradients in f32 of ``<y, w> + 0.01 aux`` for a fixed cotangent w,
    with respect to the input and the layer's router and experts: the
    port's autograd through the index-form dispatch and combine against
    ``jax.grad`` through the reference's one-hot einsums.  The router's
    gradient arrives through the gates and the aux loss only."""
    jcfg, cfg, jp, tp = pair
    jl = {k: v.astype(jnp.float32) for k, v in _layer0(jp).items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)

    def j_obj(lp, xx):
        y, aux = JMOE.moe_ffn(lp, xx, jcfg, capacity_factor=factor)
        return jnp.sum(y * w) + 0.01 * aux
    jg, jx = jax.grad(j_obj, argnums=(0, 1))(jl, jnp.asarray(x))
    tl = {k: v.float().requires_grad_() for k, v in _layer0(tp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = MOE.moe_ffn(tl, tx, cfg, capacity_factor=factor)
    ((y * torch.from_numpy(w)).sum() + 0.01 * aux).backward()
    rel = {n: float(np.linalg.norm(tl[n].grad.numpy() - np.asarray(g))
                    / np.linalg.norm(np.asarray(g))) for n, g in jg.items()}
    rel["x"] = float(np.linalg.norm(tx.grad.numpy() - np.asarray(jx))
                     / np.linalg.norm(np.asarray(jx)))
    print(f"f32 moe grads factor {factor}: {rel}")
    assert max(rel.values()) < GRAD_REL, rel


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 65)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("factor", [8.0, 1.0])
def test_loss_and_grads_match_jax(pair, factor):
    """``loss_fn`` (the NLL plus 0.01 times the layers' summed aux) and its
    bf16 gradients at the reduced config's dropless capacity and at one
    that drops, against ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg, jp, tp = pair
    jcfg = jcfg.reduced(capacity_factor=factor)
    cfg = cfg.reduced(capacity_factor=factor)
    batch = _batch(cfg, 3)
    jl, jg = jax.jit(jax.value_and_grad(j_build_model(jcfg).loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {n: t.detach().requires_grad_() for n, t in _leaves(tp)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        return leaves[prefix]
    loss = build_model(cfg).loss_fn(rebuild(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    gap = abs(float(loss.detach()) - float(jl))
    rel = {}
    for name, g in _leaves(jg):
        g = np.asarray(g).astype(np.float32)
        got = leaves[name].grad
        assert got is not None and tuple(got.shape) == g.shape, name
        assert got.dtype == leaves[name].dtype, name
        rel[name] = float(np.linalg.norm(got.float().numpy() - g)
                          / (np.linalg.norm(g) + 1e-30))
    worst = max(rel, key=rel.get)
    print(f"bf16 loss factor {factor}: {float(loss)} vs {float(jl)}, |Δ| "
          f"{gap}; worst leaf {worst} {rel[worst]}; router "
          f"{rel['/layers/moe/router']}")
    assert gap < LOSS_TOL_BF16
    assert rel[worst] < GRAD_REL_BF16, worst


def test_aux_enters_the_loss(pair):
    """The loss is the NLL plus 0.01 times the aux summed over the layers,
    and the aux is > 0."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import chunked_xent
    _, cfg, _, tp = pair
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 33)))
    h, aux = TF.forward_aux(tp, cfg, toks[:, :-1], remat=False)
    nll = chunked_xent(h, tp["unembed"], toks[:, 1:])
    loss = build_model(cfg).loss_fn(tp, {"tokens": toks[:, :-1],
                                         "targets": toks[:, 1:]})
    assert float(aux) > 0
    assert float(loss) == pytest.approx(float(nll + 0.01 * aux), rel=1e-6)
