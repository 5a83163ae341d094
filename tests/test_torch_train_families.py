"""Training the moe, vlm and encdec families: the port against the JAX
package on the same numbers.

Reduced granite-moe-1b, llava-next-34b (its stub vision embeddings
ahead of the tokens) and whisper-small (stub frames), and every assigned
architecture's reduced config run through each entry point: JAX's
``init_params(jax.random.key(0))`` crosses to the port bit for bit, the
same numpy inputs go through both, and the port runs on CPU tensors.

Tolerances, from readings of these tests (run with ``-s``), each about
twice its reading.  One train step (two microbatches): |Δloss|, the grad
norm's relative gap, then the moments' worst leaf (relative Frobenius:
they carry the bf16 gradients' gap, v squared): granite-moe 1.9e-5,
0.0024, 0.056 (``layers/ln1``); llava 7.7e-5, 1.6e-4, 0.021
(``layers/ln1``); whisper 1.3e-5, 4.1e-4, 0.034 (``dec_layers/lnx``).
The vlm prefill with vision embeddings: max |Δlogit| 0.0098 (logit std
0.22).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.launch.train as JLT
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import transformer as JTF
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as JO

import repro_torch.launch.train as LT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.train import adamw_init, make_train_step

FAMILIES = ["granite_moe_1b", "llava_next_34b", "whisper_small"]
LOSS_TOL = {"granite_moe_1b": 4e-5, "llava_next_34b": 1.6e-4,
            "whisper_small": 3e-5}
GNORM_REL = {"granite_moe_1b": 5e-3, "llava_next_34b": 4e-4,
             "whisper_small": 1e-3}
MOMENT_REL = {"granite_moe_1b": 0.12, "llava_next_34b": 0.045,
              "whisper_small": 0.07}
VLM_LOGIT_TOL = 0.02


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _pair(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    assert repr(jcfg) == repr(cfg)
    jm = j_build_model(jcfg)
    jp, _ = jm.init_params(jax.random.key(0))
    return jcfg, jm, jp, build_model(cfg), params_from_jax(jp, "cpu")


def _batch(cfg, B, S, seed):
    """numpy tokens and targets, plus the family's stub input as a bf16
    JAX array (its bits crossed to the port)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    j = {"tokens": jnp.asarray(toks[:, :-1]),
         "targets": jnp.asarray(toks[:, 1:])}
    if cfg.family == "encdec":
        j["frames"] = jnp.asarray(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)), jnp.bfloat16)
    if cfg.family == "vlm":
        j["vision_embeds"] = jnp.asarray(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)), jnp.bfloat16)
    return j, {k: params_from_jax(v, "cpu") for k, v in j.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """One step of ``make_train_step`` (two microbatches, remat, AdamW)
    from the same parameters on the same batch: loss, grad norm, learning
    rate, the updated parameters (within 3 lr: AdamW's first step moves an
    element by at most lr) and the moments, which carry the gradients."""
    jcfg, jm, jp, model, tp = _pair(arch)
    jb, tb = _batch(jcfg, 4, 32, 9)
    jp2, jopt, jmet = jax.jit(j_make_train_step(jm, num_microbatches=2))(
        jp, JO.adamw_init(jp), jb)
    tp2, topt, tmet = make_train_step(model, num_microbatches=2)(
        tp, adamw_init(tp), tb)
    gap = abs(float(tmet["loss"]) - float(jmet["loss"]))
    gn = abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(topt.step) == int(jopt.step) == 1
    lr = float(jmet["lr"])
    tl = dict(_leaves(tp2))
    for name, a in _leaves(jp2):
        assert tl[name].dtype == params_from_jax(a, "cpu").dtype, name
        np.testing.assert_allclose(_f32(tl[name]), _f32(a), rtol=2.0 ** -7,
                                   atol=3 * lr, err_msg=name)
    moments = {}
    for tree_t, tree_j in ((topt.m, jopt.m), (topt.v, jopt.v)):
        tt = dict(_leaves(tree_t))
        for name, a in _leaves(tree_j):
            assert tt[name].dtype == torch.float32
            moments[name] = max(moments.get(name, 0.0), _rel(tt[name], a))
    worst = max(moments, key=moments.get)
    print(f"{arch}: loss {float(tmet['loss'])} vs {float(jmet['loss'])}, "
          f"|Δ| {gap}; grad norm rel {gn}; worst moment {worst} "
          f"{moments[worst]}")
    assert gap < LOSS_TOL[arch]
    assert gn < GNORM_REL[arch]
    assert moments[worst] < MOMENT_REL[arch], worst


def test_vlm_prefill_with_vision_embeds_matches_jax():
    """llava's prefill over vision embeddings then tokens, positions over
    the whole sequence, last-position logits."""
    jcfg, _, jp, model, tp = _pair("llava_next_34b")
    jb, tb = _batch(jcfg, 2, 20, 10)
    h, _, _ = JTF.forward(jp, jcfg, jb["tokens"],
                          vision_embeds=jb["vision_embeds"], remat=False)
    want = np.asarray((h[:, -1] @ jp["unembed"].astype(jnp.bfloat16)
                       ).astype(jnp.float32))
    got = model.prefill(tp, tb["tokens"].long(),
                        vision_embeds=tb["vision_embeds"])
    gap = float(np.abs(got.numpy() - want).max())
    print(f"vlm prefill with vision embeds: max |Δlogit| {gap}, logit std "
          f"{want.std()}")
    assert gap < VLM_LOGIT_TOL


def test_vlm_loss_is_on_text_positions():
    """The vlm loss takes its NLL over the text positions only: it equals
    the cross-entropy of the forward's text slice."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import chunked_xent
    jcfg, _, _, model, tp = _pair("llava_next_34b")
    _, tb = _batch(jcfg, 2, 16, 11)
    h = TF.forward(tp, model.cfg, tb["tokens"], tb["vision_embeds"],
                   remat=False)
    assert h.shape[1] == jcfg.n_vision_tokens + 16
    want = chunked_xent(h[:, jcfg.n_vision_tokens:], tp["unembed"],
                        tb["targets"])
    assert float(model.loss_fn(tp, tb)) == float(want)


@pytest.mark.parametrize("arch", ["whisper_small", "llava_next_34b"])
def test_train_loop_draws_the_reference_inputs(arch, monkeypatch, tmp_path):
    """Each package's ``train_loop`` feeds its train step the same frames
    or vision embeddings (and tokens) at each step, bit for bit: the
    steps' batches are recorded in both loops."""
    seen = {"j": [], "t": []}

    def recorder(make, key, wrap):
        def make_recording(model, **kw):
            step = make(model, **kw)

            def run(params, opt, batch):
                seen[key].append({k: np.array(v) if key == "j" else
                                  wrap(v) for k, v in batch.items()})
                return step(params, opt, batch)
            return run
        return make_recording

    def bits(t):
        t = t.cpu()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    monkeypatch.setattr(JLT, "make_train_step",
                        recorder(JLT.make_train_step, "j", None))
    monkeypatch.setattr(JLT.jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(LT, "make_train_step",
                        recorder(LT.make_train_step, "t", bits))
    kw = dict(steps=2, global_batch=2, seq_len=8, log=lambda *a: None)
    JLT.train_loop(arch, ckpt_dir=tmp_path / "j", **kw)
    LT.train_loop(arch, ckpt_dir=tmp_path / "t", device="cpu", **kw)
    key = "frames" if arch == "whisper_small" else "vision_embeds"
    assert len(seen["j"]) == len(seen["t"]) == 2
    for j, t in zip(seen["j"], seen["t"]):
        assert set(j) == set(t)
        assert j[key].dtype.name == "bfloat16"
        np.testing.assert_array_equal(t[key], j[key].view(np.uint16))
        np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert not np.array_equal(seen["t"][0][key], seen["t"][1][key])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_on_the_cpu(arch):
    """Every assigned architecture's reduced config: ``init_params``,
    ``prefill``, ``loss_fn`` with a backward pass and two ``decode_fn``
    steps on CPU tensors, finite throughout (the encdec decode against
    its encoder's states)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 13), generator=g)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                      generator=g).bfloat16()
    if cfg.family == "vlm":
        extra["vision_embeds"] = torch.randn(
            2, cfg.n_vision_tokens, cfg.d_model, generator=g).bfloat16()
    logits = model.prefill(params, toks[:, :-1], **extra)
    assert logits.shape == (2, cfg.vocab) and bool(logits.isfinite().all())
    leaves = [t.requires_grad_() for _, t in _leaves(params)]
    loss = model.loss_fn(params, {"tokens": toks[:, :-1],
                                  "targets": toks[:, 1:], **extra})
    loss.backward()
    assert bool(loss.isfinite()) and all(
        t.grad is not None and bool(t.grad.isfinite().all()) for t in leaves)
    with torch.no_grad():
        enc = (model.encode(params, extra["frames"])
               if cfg.family == "encdec" else None)
        cache = model.init_cache(2, 4, device="cpu")
        for t in range(2):
            step, cache = model.decode_fn(params, cache, toks[:, t:t + 1], t,
                                          **({"enc_out": enc} if enc
                                             is not None else {}))
            assert step.shape == (2, cfg.vocab)
            assert bool(step.isfinite().all())
