"""The port's model stack against the JAX package on the same parameters.

Reduced zamba2-1.2b (hybrid), mamba2-130m (ssm), llama3-8b (dense),
granite-moe-1b and mixtral-8x22b (moe; dropless at this size, as the
reference's reduced config is) and llava-next-34b (vlm, tokens only: the
vision embeddings are held in ``test_torch_train_families.py``):
JAX's ``init_params(jax.random.key(0))`` crosses to the port bit for bit
(``params_from_jax``), the same numpy tokens go through both, and the
port runs on CPU tensors (its kernels' plain versions).

Tolerance, per arch: logits within ``LOGIT_TOL`` absolute and caches
within ``CACHE_REL`` relative error in the Frobenius norm, each about
twice the largest reading of these tests (logits have a standard
deviation of about 0.23 here).  The tests print their readings (run
with ``-s``).  Readings, max |Δlogit| over the prefill
and the six decode steps, then the worst cache: zamba2 0.0293 (decode
step 3; prefill 0.0234), cache 0.0208; mamba2 0.0171 (step 3; prefill
0.0107), cache 0.0104; llama3 0.0078 (prefill and steps 0, 3-5), cache
0.0046; granite-moe 0.0117 (prefill; decode 0.0103 at step 3), cache
0.0045; mixtral 0.0103 (decode step 3; prefill 0.0088), cache 0.0045
(six steps stay inside its reduced window of 32, and its reduced config
is granite-moe's otherwise); llava 0.0098 (prefill; decode 0.0078), cache
0.0048.  Both packages compute in bf16 with f32 reductions, but XLA's
fused CPU code keeps excess precision (an f32 intermediate it never
rounds) where torch rounds every eager op's output to bf16, so the two
differ by a few bf16 roundings per layer.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import transformer as JTF

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import build_model
from repro_torch.models import transformer as TF

ARCHS = ["zamba2_1p2b", "mamba2_130m", "llama3_8b", "granite_moe_1b",
         "mixtral_8x22b", "llava_next_34b"]
LOGIT_TOL = {"zamba2_1p2b": 0.06, "mamba2_130m": 0.04, "llama3_8b": 0.02,
             "granite_moe_1b": 0.025, "mixtral_8x22b": 0.025,
             "llava_next_34b": 0.02}
CACHE_REL = {"zamba2_1p2b": 0.04, "mamba2_130m": 0.02, "llama3_8b": 0.01,
             "granite_moe_1b": 0.01, "mixtral_8x22b": 0.01,
             "llava_next_34b": 0.01}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    assert jcfg == cfg or repr(jcfg) == repr(cfg)
    jm = j_build_model(jcfg)
    jp, _ = jm.init_params(jax.random.key(0))
    return arch, jcfg, jm, jp, build_model(cfg), params_from_jax(jp, "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_from_jax_round_trip_is_bit_exact(pair):
    _, _, _, jp, _, tp = pair
    back = dict(_leaves(params_to_numpy(tp)))
    jl = dict(_leaves(jp))
    assert back.keys() == jl.keys()
    for name, a in jl.items():
        a = np.asarray(a)
        want = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)


def test_init_params_matches_reference_tree(pair):
    """The port's own random init has the reference's tree, shapes and
    dtypes."""
    _, _, _, jp, model, _ = pair
    mine = dict(_leaves(model.init_params(0, device="cpu")))
    for name, a in _leaves(jp):
        assert tuple(mine[name].shape) == tuple(a.shape), name
        assert str(mine[name].dtype).split(".")[-1] == str(a.dtype), name
    assert mine.keys() == dict(_leaves(jp)).keys()


def test_prefill_matches_jax(pair):
    arch, jcfg, _, jp, model, tp = pair
    toks = _tokens(jcfg, 2, 40, 1)
    h, _, _ = JTF.forward(jp, jcfg, jnp.asarray(toks), remat=False)
    want = np.asarray((h[:, -1] @ jp["unembed"].astype(jnp.bfloat16)
                       ).astype(jnp.float32))
    got = model.prefill(tp, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    gap = np.abs(got.numpy() - want).max()
    print(f"{arch}: prefill max |Δlogit| {gap}, logit std {want.std()}")
    assert gap < LOGIT_TOL[arch]


def test_decode_steps_match_jax(pair):
    """Six decode steps from an empty cache: logits each step, and the
    whole cache after the last."""
    arch, jcfg, jm, jp, model, tp = pair
    B, steps = 2, 6
    toks = _tokens(jcfg, B, steps, 2)
    jc, _ = jm.init_cache(B, 16)
    tc = model.init_cache(B, 16, device="cpu")
    assert set(tc) == set(jc)
    gaps = []
    for t in range(steps):
        jl, jc = jm.decode_fn(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        tl, tc = model.decode_fn(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), t)
        gaps.append(float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    rel = {}
    for k in jc:
        a = np.asarray(jc[k]).astype(np.float32)
        b = tc[k].float().numpy()
        assert a.shape == b.shape and tc[k].dtype == params_from_jax(
            jc[k], "cpu").dtype, k
        rel[k] = float(np.linalg.norm(a - b) / np.linalg.norm(a))
    print(f"{arch}: decode max |Δlogit| by step {gaps}, cache {rel}")
    assert max(gaps) < LOGIT_TOL[arch], gaps
    assert max(rel.values()) <= CACHE_REL[arch], rel


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 0.15),
                                       (torch.float32, 1e-4)])
def test_teacher_forced_decode_matches_own_prefill(pair, dtype, tol):
    """The port's decode path (ring cache, recurrent SSM update: no
    kernel) against its own prefill (the attention and SSD kernels' plain
    versions) at every position of a 70-token prompt (a ragged chunk).
    bf16: the reference's own tolerance for this check (``tests/
    test_archs.py``: rtol = atol = 0.15).  f32 (the same weights cast):
    1e-4, summation order only, so the two algorithms agree."""
    _, jcfg, _, _, model, tp = pair
    cfg, tp = model.cfg, _cast(tp, dtype)
    toks = torch.from_numpy(_tokens(jcfg, 1, 70, 7)).long()
    full = (TF.forward(tp, cfg, toks) @ tp["unembed"]).float()
    cache = model.init_cache(1, 70, device="cpu", dtype=dtype)
    steps = [model.decode_fn(tp, cache, toks[:, t:t + 1], t)[0]
             for t in range(70)]
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=tol, atol=tol)


def test_per_row_cache_index_equals_separate_rows(pair):
    """The engine's batched decode: rows at different positions in one
    call (``cache_index [B]``: per-row rope, ring write and mask) equal
    each row decoded alone at its own position."""
    _, jcfg, _, _, model, tp = pair
    toks = torch.from_numpy(_tokens(jcfg, 2, 6, 3)).long()
    lens = [5, 2]
    alone, caches = [], []
    for r, n in enumerate(lens):
        c = model.init_cache(1, 8, device="cpu")
        for t in range(n):
            model.decode_fn(tp, c, toks[r:r + 1, t:t + 1], t)
        caches.append({k: v.clone() for k, v in c.items()})
        alone.append(model.decode_fn(tp, c, toks[r:r + 1, n:n + 1], n)[0])
    both = {k: torch.cat([caches[0][k], caches[1][k]], 1) for k in caches[0]}
    tk = torch.stack([toks[0, lens[0]], toks[1, lens[1]]])[:, None]
    lg, _ = model.decode_fn(tp, both, tk, torch.tensor(lens))
    for r in range(2):
        assert np.abs(lg[r].numpy() - alone[r][0].numpy()).max() < 1e-2
