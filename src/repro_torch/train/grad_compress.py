"""Gradient compression for a slow cross-node reduction: int8 blocks with
f32 scales and error feedback.

Counterpart of ``repro/train/grad_compress.py``, plain tensor code (the
reference has no kernel here).  Each leaf (plus the carried residual) is
cut into blocks of ``BLOCK`` values, each block scaled by its max |x| /
127 and rounded half to even (``torch.round``, as ``jnp.round``), so the
int8 payload is the reference's, value for value.  The residual ``x -
dequant(q)`` is carried into the next step, which keeps the sum of what
was sent equal to the sum of the gradients plus the last residual.
Trees are nested dicts of tensors, leaves in the reference's order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import rebuild, tree_leaves

BLOCK = 1024


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_grads(grads, residual):
    """Quantize ``grads + residual`` (residual None: zeros).  Returns
    ``(payload, new_residual)``: payload a tree of ``(int8 blocks
    [n_blocks, BLOCK], f32 scales [n_blocks, 1])`` pairs, ready for the
    reduction; new_residual what the int8 payload did not carry."""
    flat_g = tree_leaves(grads)
    flat_r = (tree_leaves(residual) if residual is not None else
              [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for g in flat_g])
    payload, new_res = [], []
    for g, r in zip(flat_g, flat_r):
        x = g.float() + r
        q, s = _quant_int8(x)
        payload.append((q, s))
        new_res.append(x - _dequant(q, s, g.shape))
    return rebuild(grads, iter(payload)), rebuild(grads, iter(new_res))


def decompress_grads(payload, shapes):
    """The f32 gradients of ``payload``, shaped like the leaves of
    ``shapes`` (a tree of tensors, or anything with ``.shape``)."""
    flat = iter(tree_leaves(payload))      # q, scale, q, scale, ...
    return rebuild(shapes, (_dequant(q, next(flat), g.shape)
                            for q, g in zip(flat, tree_leaves(shapes))))


def compression_ratio(grads) -> float:
    """Bytes of int8 plus scales over bytes of bf16."""
    leaves = tree_leaves(grads)
    total_in = sum(g.numel() * 2 for g in leaves)
    total_out = sum(g.numel() + (g.numel() // BLOCK + 1) * 4 for g in leaves)
    return total_out / total_in
