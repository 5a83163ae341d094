"""The train step: loss and gradients, gradient accumulation over
microbatches, then AdamW.

Counterpart of ``repro/train/train_step.py:make_train_step``.  The
reference accumulates microbatches in a ``lax.scan`` (``costing.scan``,
an unroll switch for XLA's cost analysis that has no meaning here); this
is a Python loop with the same arithmetic: f32 gradients summed ``/ M``.
Gradients come from ``torch.autograd.grad`` over detached copies of the
parameters, so the caller's tensors need no ``requires_grad``.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map
from .optimizer import AdamWState, adamw_update, cosine_lr


def value_and_grad(model, params, batch, remat: bool = True):
    """(loss, grads) of ``model.loss_fn`` at ``params``; grads in each
    parameter's type, as ``jax.value_and_grad`` gives them."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(leaves, batch, remat=remat)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    order = {id(t): next(it) for t in flat}
    return loss.detach(), tree_map(lambda p: order[id(p)], leaves)


def make_train_step(model, *, num_microbatches: int = 1,
                    base_lr: float = 3e-4, total_steps: int = 10_000,
                    remat: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with metrics ``{"loss", "grad_norm", "lr"}`` (0-d
    f32 tensors on the parameters' device: no host sync).

    Batch leaves have the global batch as their leading dim; with
    ``num_microbatches = M`` each is cut into M equal microbatches whose
    losses and f32 gradients are summed ``/ M``."""
    M = num_microbatches

    def grads_of(params, batch):
        if M == 1:
            return value_and_grad(model, params, batch, remat)
        n = next(iter(batch.values())).shape[0]
        if n % M:
            raise ValueError(f"global batch {n} is not a multiple of "
                             f"num_microbatches={M}")
        per = n // M
        loss_acc = None
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(M):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, g = value_and_grad(model, params, mb, remat)
            # in place: the same sum as a + b / M, without a second copy
            g_acc = tree_map(lambda a, b: a.add_(b.float() / M), g_acc, g)
            loss_acc = (loss / M if loss_acc is None
                        else loss_acc + loss / M)
        return loss_acc, g_acc

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = grads_of(params, batch)
        lr = cosine_lr(opt_state.step, base_lr=base_lr, total=total_steps)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state, lr)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step
