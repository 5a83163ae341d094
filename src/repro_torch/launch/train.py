"""Training loop: the train step run step by step with checkpoint/restart and
the queue-ordered data pipeline.

  python -m repro_torch.launch.train --arch llama3_8b --steps 50 [--device cpu]

Counterpart of ``repro/launch/train.py``.  Trains the reduced config of
``--arch`` (or, from Python, any :class:`ArchConfig`) on batches from
:class:`GlobalOrderPipeline` (``batch_at_step``: a pure function of the
step, so a replayed step sees the same batch), with AdamW through
:func:`make_train_step`, checkpoints ``{"params", "opt"}`` in the
reference's on-disk format every ``ckpt_every`` steps, and recovers from
injected failures by restarting from the latest checkpoint
(:func:`run_with_restarts`).  The encdec family's frames and the vlm
family's vision embeddings are drawn as the reference draws them
(``numpy.random.default_rng(step)``, standard normal, rounded to bf16),
so both packages train on the same inputs.  It runs on CUDA unless
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ArchConfig, get_config
from ..data import GlobalOrderPipeline
from ..fault import FailureInjector, run_with_restarts
from ..kernels.backend import resolve_device
from ..models import build_model
from ..train import adamw_init, make_train_step
from ..tree import tree_map


def stub_inputs(cfg, step: int, global_batch: int, device) -> dict:
    """The stub modality inputs of ``step``, as the reference's loop draws
    them (``repro/launch/train.py:47-56``): ``frames`` [B, enc_seq, d]
    for encdec, ``vision_embeds`` [B, n_vision_tokens, d] for vlm,
    ``default_rng(step).standard_normal`` rounded to bf16 (through f32,
    as the reference's conversion rounds), on ``device``; {} for the
    other families."""
    key, n = {"encdec": ("frames", cfg.enc_seq),
              "vlm": ("vision_embeds", cfg.n_vision_tokens)}.get(
        cfg.family, (None, 0))
    if key is None:
        return {}
    x = np.random.default_rng(step).standard_normal(
        (global_batch, n, cfg.d_model))
    return {key: torch.from_numpy(x.astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)}


def train_loop(arch, *, reduced: bool = True, steps: int = 50,
               global_batch: int = 8, seq_len: int = 64, ckpt_dir=None,
               ckpt_every: int = 10, fail_at=(), log=print, device=None,
               params=None):
    """Train for ``steps`` steps; returns ``(state, losses, metrics)``:
    the final ``{"params", "opt"}``, ``[(step, loss)]`` of every step run
    (a replayed step appears twice) and the restart accounting.

    ``arch``: an architecture id (its reduced config when ``reduced``) or
    an :class:`ArchConfig` taken as it is.  ``params``: the initial
    parameters (default: ``init_params`` from seed 0, on ``device``)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced and not isinstance(arch, ArchConfig):
        cfg = cfg.reduced()
    dev = resolve_device(device)
    model = build_model(cfg)
    pipe = GlobalOrderPipeline(seq_len, cfg.vocab, global_batch, device=dev)
    train_step = make_train_step(model, total_steps=steps)

    def init_state():
        p = params if params is not None else model.init_params(0,
                                                                device=dev)
        return {"params": p, "opt": adamw_init(p)}

    losses = []

    def step_fn(state, step):
        # a restored checkpoint is on the host
        state = tree_map(lambda t: t.to(dev), state)
        batch = pipe.batch_at_step(step)
        batch = {k: v for k, v in batch.items() if k != "sample_indices"}
        batch.update(stub_inputs(cfg, step, global_batch, dev))
        p, opt, metrics = train_step(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append((step, loss))
        if step % 10 == 0:
            log(f"step {step:4d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": p, "opt": opt}

    if ckpt_dir is None:
        import tempfile
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    injector = FailureInjector(fail_at_steps=tuple(fail_at))
    state, metrics = run_with_restarts(
        init_state=init_state, step_fn=step_fn, n_steps=steps,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, injector=injector, log=log)
    return tree_map(lambda t: t.to(dev), state), losses, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    _, losses, metrics = train_loop(
        args.arch, reduced=args.reduced, steps=args.steps,
        global_batch=args.global_batch, seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir, device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"done in {time.time() - t0:.1f}s on {args.device}; "
          f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}; {metrics}")


if __name__ == "__main__":
    main()
