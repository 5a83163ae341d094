"""The port's training path against the JAX package on the same numbers.

Parameters cross from JAX's ``init_params(jax.random.key(0))`` bit for
bit (``params_from_jax``); tokens are numpy draws or the data pipeline's
(the same in both packages); the port runs on CPU tensors (its kernels'
plain versions, with their hand-written backward passes).

Tolerances, from readings of these tests (run with ``-s``; each bound is
about twice its reading).  Both packages compute in bf16 with f32
reductions, but XLA's fused CPU code keeps excess precision where torch
rounds each op's output, so bf16 gradients of random-weight models
differ by a few per cent.  Each package's bf16 gradients are about as
far from the port's f32 gradients of the same weights (the unembedding
rounded to bf16 in both, as the reference rounds it) as from each other
(zamba2 0.081 and 0.079, mamba2 0.061 and 0.053, llama3 0.021 and 0.019,
relative Frobenius error of the worst leaf), so the gap is bf16's
rounding and not a wrong gradient.  Readings, port against JAX: the
worst leaf's relative error at 2 x 64 tokens, zamba2 0.080, mamba2 0.048,
llama3 0.019, granite, internlm2 and mistral-large 0.020 (their reduced
configs coincide); |Δloss| over 24 batches (8 seeds x 16, 32, 64
tokens), largest and median, zamba2 2.5e-3 and 7.3e-4, mamba2 8.9e-4 and
3.0e-4, llama3 6.8e-4 and 2.1e-4.  The optimizer, the schedule and the
loop are held tighter (f32 arithmetic, the same order of operations).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_config as j_get_config
from repro.launch.train import train_loop as j_train_loop
from repro.models import build_model as j_build_model
from repro.train import optimizer as JO
from repro.train import make_train_step as j_make_train_step

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model
from repro_torch.train import adamw_init, adamw_update, make_train_step
from repro_torch.train.optimizer import AdamWState, cosine_lr, global_norm

ARCHS = ["llama3_8b", "mamba2_130m", "zamba2_1p2b", "granite_3_8b",
         "internlm2_20b", "mistral_large_123b"]
LOSS_TOL = {"zamba2_1p2b": 5e-3, "mamba2_130m": 2e-3, "llama3_8b": 1.5e-3,
            "granite_3_8b": 1.5e-3, "internlm2_20b": 1.5e-3,
            "mistral_large_123b": 1.5e-3}
GRAD_REL = {"zamba2_1p2b": 0.16, "mamba2_130m": 0.1, "llama3_8b": 0.04,
            "granite_3_8b": 0.04, "internlm2_20b": 0.04,
            "mistral_large_123b": 0.04}
# train_loop over 20 reduced-llama steps: max |Δloss| read 2.9e-4
LOOP_TOL = 1e-3
ROOT = Path(__file__).resolve().parents[1]


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


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _pair(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build_model(jcfg)
    jp, _ = jm.init_params(jax.random.key(0))
    return jcfg, jm, jp, build_model(cfg), params_from_jax(jp, "cpu")


def _port_value_and_grad(model, params, batch, remat=True):
    leaves = {n: t.detach().requires_grad_() for n, t in _leaves(params)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        return leaves[prefix]
    loss = model.loss_fn(rebuild(params), {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                         remat=remat)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, jm, jp, model, tp = _pair(arch)
    batch = _batch(jcfg, 2, 64, 0)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_value_and_grad(model, tp, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    gap = abs(float(loss) - float(jl))
    worst = {}
    for name, g in _leaves(jg):
        assert grads[name].dtype == params_from_jax(g, "cpu").dtype, name
        assert tuple(grads[name].shape) == tuple(g.shape), name
        worst[name] = _rel(grads[name], g)
    name = max(worst, key=worst.get)
    print(f"{arch}: loss {float(loss)} vs {float(jl)}, |Δ| {gap}; worst "
          f"leaf {name} {worst[name]}")
    assert gap < LOSS_TOL[arch]
    assert worst[name] < GRAD_REL[arch], name


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "llama3_8b"])
def test_remat_equals_no_remat_exactly(arch):
    """Recomputing each layer in the backward changes nothing on the CPU:
    the loss and every gradient are bit for bit the same."""
    jcfg, _, _, model, tp = _pair(arch)
    batch = _batch(jcfg, 2, 40, 3)
    la, ga = _port_value_and_grad(model, tp, batch, remat=True)
    lb, gb = _port_value_and_grad(model, tp, batch, remat=False)
    assert torch.equal(la, lb)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_loss_masks_invalid_positions():
    """``valid`` drops positions from the mean, as the reference does."""
    jcfg, jm, jp, model, tp = _pair("llama3_8b")
    batch = _batch(jcfg, 2, 32, 4)
    valid = np.random.default_rng(5).random((2, 32)) < 0.6
    want = float(jm.loss_fn(jp, {**{k: jnp.asarray(v)
                                    for k, v in batch.items()},
                                 "valid": jnp.asarray(valid)}))
    got = float(model.loss_fn(tp, {**{k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                                   "valid": torch.from_numpy(valid)}))
    assert abs(got - want) < LOSS_TOL["llama3_8b"]


@pytest.mark.parametrize("step", [0, 99, 100, 5_000, 10_000])
def test_cosine_lr_matches_jax(step):
    got = float(cosine_lr(torch.tensor(step, dtype=torch.int32)))
    want = float(JO.cosine_lr(jnp.int32(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def _tree(rng):
    """A small parameter tree with bf16 matrices and f32 vectors."""
    return {"w": rng.standard_normal((64, 48)).astype(np.float32) * 0.1,
            "blk": {"a": rng.standard_normal((3, 32, 16)).astype(np.float32),
                    "b": rng.standard_normal((16,)).astype(np.float32)}}


def test_adamw_three_steps_match_jax():
    rng = np.random.default_rng(7)
    p_np = _tree(rng)
    jp = {"w": jnp.asarray(p_np["w"], jnp.bfloat16),
          "blk": {"a": jnp.asarray(p_np["blk"]["a"], jnp.bfloat16),
                  "b": jnp.asarray(p_np["blk"]["b"])}}
    tp = params_from_jax(jp, "cpu")
    jst, tst = JO.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g_np = {k: v * (1 + step) for k, v in _tree(rng).items()
                if k == "w"}
        g_np["blk"] = {k: v * 3.0 for k, v in _tree(rng)["blk"].items()}
        jgr = {"w": jnp.asarray(g_np["w"], jnp.bfloat16),
               "blk": {k: jnp.asarray(v) for k, v in g_np["blk"].items()}}
        tgr = params_from_jax(jgr, "cpu")
        assert float(global_norm(tgr)) == pytest.approx(
            float(JO.global_norm(jgr)), rel=1e-6)
        lr = 1e-2 * (step + 1)
        jp, jst, jn = JO.adamw_update(jp, jgr, jst, jnp.float32(lr))
        tp, tst, tn = adamw_update(tp, tgr, tst, torch.tensor(lr))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert int(tst.step) == int(jst.step) == step + 1
        for name, a in _leaves(jp):
            b = dict(_leaves(tp))[name]
            assert b.dtype == params_from_jax(a, "cpu").dtype
            # f32 leaves: f32 rounding only; bf16 leaves: at most one
            # bf16 step where the f32 update lands near a rounding edge
            step_size = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_f32(b), _f32(a), rtol=step_size,
                                       atol=1e-7, err_msg=name)
        for tree_t, tree_j in ((tst.m, jst.m), (tst.v, jst.v)):
            for name, a in _leaves(tree_j):
                # f32 rounding of the clipped gradient, where m sums to
                # near 0 across steps: an absolute part of the leaf's max
                a = _f32(a)
                np.testing.assert_allclose(_f32(dict(_leaves(tree_t))[name]),
                                           a, rtol=1e-5,
                                           atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_jax(M):
    jcfg, jm, jp, model, tp = _pair("zamba2_1p2b")
    batch = _batch(jcfg, 4, 32, 9)
    jstep = jax.jit(j_make_train_step(jm, num_microbatches=M))
    jp2, jopt, jmet = jstep(jp, JO.adamw_init(jp),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(model, num_microbatches=M)
    tp2, topt, tmet = tstep(tp, adamw_init(tp), {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) < LOSS_TOL[
        "zamba2_1p2b"]
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=GRAD_REL["zamba2_1p2b"])
    assert int(topt.step) == int(jopt.step) == 1
    tl = dict(_leaves(tp2))
    lr = float(jmet["lr"])
    for name, a in _leaves(jp2):
        assert tl[name].dtype == params_from_jax(a, "cpu").dtype, name
        # AdamW's first step moves each element by at most lr whatever
        # its gradient, so this holds for any gradients (2·lr plus one
        # bf16 rounding step): it checks the step itself (learning rate,
        # weight decay, the cast back); the moments below carry the
        # gradients
        np.testing.assert_allclose(_f32(tl[name]), _f32(a), rtol=2.0 ** -7,
                                   atol=3 * lr, err_msg=name)
    for tree_t, tree_j in ((topt.m, jopt.m), (topt.v, jopt.v)):
        tt = dict(_leaves(tree_t))
        for name, a in _leaves(tree_j):
            assert tt[name].dtype == torch.float32
            # the moments carry the gradients' bf16 gap (v: squared)
            assert _rel(tt[name], a) < 2 * GRAD_REL["zamba2_1p2b"], name


def test_train_step_microbatches_average_the_full_batch():
    """M = 2 takes the mean of the two halves' losses: in f32 it equals
    the one-batch loss to rounding."""
    jcfg, _, _, model, tp = _pair("llama3_8b")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(jcfg, 4, 16, 11).items()}
    params = _cast(tp, torch.float32)
    one = make_train_step(model, num_microbatches=1)(
        params, adamw_init(params), batch)[2]
    two = make_train_step(model, num_microbatches=2)(
        params, adamw_init(params), batch)[2]
    assert float(two["loss"]) == pytest.approx(float(one["loss"]), rel=1e-5)
    assert float(two["grad_norm"]) == pytest.approx(
        float(one["grad_norm"]), rel=1e-4)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def test_train_loop_matches_jax_losses(tmp_path):
    """20 reduced-llama steps of each package's loop from the same
    parameters and the same data: the losses step by step."""
    _, jlosses, jmet = j_train_loop("llama3_8b", steps=20,
                                    ckpt_dir=tmp_path / "j",
                                    log=lambda *a: None)
    _, _, jp, _, tp = _pair("llama3_8b")
    _, tlosses, tmet = train_loop("llama3_8b", steps=20,
                                  ckpt_dir=tmp_path / "t", device="cpu",
                                  params=tp, log=lambda *a: None)
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == list(
        range(20))
    gap = max(abs(a - b) for (_, a), (_, b) in zip(tlosses, jlosses))
    print(f"train_loop 20 steps: max |Δloss| {gap}")
    assert gap < LOOP_TOL
    assert tmet == jmet


def test_restart_replays_bit_for_bit(tmp_path):
    """A failure at step 7 restarts from the step-5 checkpoint: steps 5
    and 6 run twice with the same loss bit for bit, and the run ends where
    an unbroken run ends."""
    kw = dict(steps=10, ckpt_every=5, device="cpu", log=lambda *a: None)
    _, broken, met = train_loop("zamba2_1p2b", ckpt_dir=tmp_path / "a",
                                fail_at=(7,), **kw)
    state, clean, _ = train_loop("zamba2_1p2b", ckpt_dir=tmp_path / "b",
                                 **kw)
    assert met["restarts"] == 1 and met["steps_run"] == 12
    assert [s for s, _ in broken] == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
    assert broken[5][1] == broken[7][1] and broken[6][1] == broken[8][1]
    assert [l for s, l in broken[7:]] == [l for s, l in clean[5:]]
    again, _ = load_checkpoint(tmp_path / "a", 10, state)
    for (n, a), (_, b) in zip(_leaves(again["params"]),
                              _leaves(state["params"])):
        assert torch.equal(a, b), n


def test_training_checkpoint_crosses_packages(tmp_path):
    """params plus AdamW m, v, step, after a real step, written by each
    package and restored by the other, bit for bit."""
    jcfg, jm, jp, model, tp = _pair("mamba2_130m")
    batch = _batch(jcfg, 2, 16, 13)
    tstep = make_train_step(model)
    tp2, topt, _ = tstep(tp, adamw_init(tp), {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    tstate = {"params": tp2, "opt": topt}
    save_checkpoint(tmp_path / "t", 1, tstate)
    jlike = {"params": jp, "opt": JO.adamw_init(jp)}
    jback, manifest = j_load_checkpoint(tmp_path / "t", 1, jlike)
    assert isinstance(jback["opt"], JO.AdamWState)
    keys = {m["key"] for m in manifest["leaves"]}
    assert "opt__step" in keys and any(k.startswith("opt__m__layers")
                                       for k in keys)
    for (n, a), (_, b) in zip(_leaves(params_to_numpy(tp2)),
                              _leaves(jback["params"])):
        np.testing.assert_array_equal(a, np.asarray(b).view(a.dtype)
                                      if a.dtype == np.uint16 else b,
                                      err_msg=n)
    for field in ("m", "v"):
        for (n, a), (_, b) in zip(_leaves(getattr(topt, field)),
                                  _leaves(getattr(jback["opt"], field))):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    assert int(jback["opt"].step) == 1

    # and back: the JAX package writes, the port restores
    j_save_checkpoint(tmp_path / "j", 1, jback)
    tlike = {"params": tp, "opt": adamw_init(tp)}
    back, _ = load_checkpoint(tmp_path / "j", 1, tlike)
    assert isinstance(back["opt"], AdamWState)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 1
    for (n, a), (_, b) in zip(_leaves(back["params"]), _leaves(tp2)):
        assert torch.equal(a, b), n
    for field in ("m", "v"):
        for (n, a), (_, b) in zip(_leaves(getattr(back["opt"], field)),
                                  _leaves(getattr(topt, field))):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("module", [
    "repro_torch.train", "repro_torch.train.grad_compress",
    "repro_torch.launch.train", "repro_torch.models",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ssd_scan"])
def test_training_modules_load_no_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` with the reference's flags
    and ``--device cpu``."""
    from repro_torch.launch.train import main
    main(["--arch", "mamba2_130m", "--steps", "3", "--seq-len", "16",
          "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done in" in out and "on cpu" in out and "'restarts': 0" in out
