"""AdamW with global-norm clipping and a cosine schedule.

Counterpart of ``repro/train/optimizer.py``, plain tensor code (the
reference has no kernel here).  The moments ``m`` and ``v`` are f32;
parameters keep their type (bf16 as initialised) and are updated in f32
and cast back.  :class:`AdamWState` keeps the reference's field names, so
a checkpoint of ``{"params", "opt"}`` has the reference's key paths
(``opt__m__...``, ``opt__v__...``, ``opt__step``).  The update is
functional, as the reference's: it returns new tensors and leaves its
arguments as they were.  Each leaf's arithmetic is the reference's, op
for op, in a loop over leaves (a model has a few dozen leaves, stacked
over its layers).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..tree import rebuild, tree_leaves, tree_map


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor          # 0-d int32, on the parameters' device


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def adamw_init(params) -> AdamWState:
    """Zero f32 moments shaped like ``params`` and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)))


def cosine_lr(step, base_lr: float = 3e-4, warmup: int = 100,
              total: int = 10_000, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac · base_lr`` at ``total``.  ``step``: an int or a
    0-d tensor (kept on its device: no host sync).  Returns 0-d f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * (s + 1) / warmup
    t = ((s - warmup) / max(1, total - warmup)).clamp(0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g²) in f32, leaves in the
    reference's order."""
    total = None
    for g in tree_leaves(tree):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def adamw_update(params, grads, state: AdamWState, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step with the gradients clipped to global norm
    ``clip_norm``.  Returns (new params, new state, grad norm before
    clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mh = m / bc1
        vh = v / bc2
        delta = mh / (vh.sqrt() + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
        params, grads, state.m, state.v)))]
    new_p, new_m, new_v = (rebuild(params, (t[i] for t in out))
                           for i in range(3))
    return new_p, AdamWState(m=new_m, v=new_v, step=step), gnorm
