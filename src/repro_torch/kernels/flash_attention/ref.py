"""Plain PyTorch versions of flash attention and its backward.

Counterparts of ``repro/kernels/flash_attention/ref.py:attention_ref``
(the full score matrix, a test oracle) and of
``repro/models/layers.py:_sdpa_chunked`` (query-chunked attention, the
CUDA kernel's plain version: a full ``[L, L]`` score matrix would not fit
at 32k tokens), and :func:`attention_backward_chunked`, the backward
kernel's plain version (the reference differentiates its jnp attention
instead).  Queries align to the END of the keys: query i attends key
positions ``<= Lk - Lq + i`` (causal) and ``> Lk - Lq + i - window``
(sliding window).  Math in float32 (float64 for float64 inputs); results
are in the inputs' type.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
CHUNK = 512


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the math runs in: f32, or f64 for f64 input."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    m = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def attention_ref(q, k, v, causal: bool = True,
                  window: Optional[int] = None):
    """q: [B, Lq, D]; k/v: [B, Lk, D] -> [B, Lq, D], softmax over the full
    masked score matrix (a row with no visible key averages v, as the
    reference's oracle does)."""
    Lq, D = q.shape[1], q.shape[2]
    Lk = k.shape[1]
    s = (_acc(q) @ _acc(k).transpose(-1, -2)) * (1.0 / D ** 0.5)
    m = _mask(torch.arange(Lq, device=q.device) + (Lk - Lq),
              torch.arange(Lk, device=q.device), causal, window)
    s = s.masked_fill(~m, NEG_INF)
    return (torch.softmax(s, -1) @ _acc(v)).to(q.dtype)


def attention_chunked(q, k, v, causal: bool = True,
                      window: Optional[int] = None, chunk: int = CHUNK):
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D] with Hq % Hkv == 0 (GQA:
    query head h reads kv head h // (Hq // Hkv)).  Returns [B, Hq, Lq, D].

    Never materializes more than ``chunk`` query rows of scores.  A query
    row with no visible key is 0 (the kernel's ``l == 0`` rule); the model
    never makes one (every query sees itself)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    G = Hq // Hkv
    kf = _acc(k)[:, :, None].transpose(-1, -2)        # [B, Hkv, 1, D, Lk]
    vf = _acc(v)[:, :, None]                          # [B, Hkv, 1, Lk, D]
    k_pos = torch.arange(Lk, device=q.device)
    out = torch.empty(B, Hq, Lq, D, dtype=q.dtype, device=q.device)
    for s0 in range(0, Lq, chunk):
        c = min(chunk, Lq - s0)
        qc = _acc(q[:, :, s0:s0 + c]).reshape(B, Hkv, G, c, D)
        s = (qc @ kf) * (1.0 / D ** 0.5)               # [B, Hkv, G, c, Lk]
        q_pos = torch.arange(s0, s0 + c, device=q.device) + (Lk - Lq)
        m = _mask(q_pos, k_pos, causal, window)
        o = torch.softmax(s.masked_fill(~m, NEG_INF), -1) @ vf
        o = torch.where(m.any(-1)[:, None], o, 0.0)
        out[:, :, s0:s0 + c] = o.reshape(B, Hq, c, D).to(q.dtype)
    return out


def attention_backward_chunked(q, k, v, o, do, causal: bool = True,
                               window: Optional[int] = None,
                               chunk: int = CHUNK):
    """Gradients ``(dq, dk, dv)`` of :func:`attention_chunked` at (q, k, v)
    given ``do`` = dL/d(out) and the forward's output ``o``, query chunk by
    chunk (FlashAttention's backward written out, the score matrix of
    ``chunk`` rows recomputed):

        P = softmax(scale Q Kᵀ),  dV = Pᵀ dO,
        dS = P ∘ (dO Vᵀ - rowsum(dO ∘ O)),  dQ = scale dS K,  dK = scale dSᵀ Q

    ``rowsum(dO ∘ O)`` is taken from ``o`` as the kernel takes it.  GQA:
    dk and dv sum over the query heads of each kv head.  A row with no
    visible key has P = 0 and contributes nothing.  Shapes as
    :func:`attention_chunked`; results in the inputs' types."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / D ** 0.5
    kf = _acc(k)[:, :, None]                          # [B, Hkv, 1, Lk, D]
    vf = _acc(v)[:, :, None]
    dsum = (_acc(do) * _acc(o)).sum(-1).reshape(B, Hkv, G, Lq)
    k_pos = torch.arange(Lk, device=q.device)
    dq = torch.empty(B, Hq, Lq, D, dtype=kf.dtype, device=q.device)
    dk = torch.zeros(B, Hkv, Lk, D, dtype=kf.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, Lq, chunk):
        c = min(chunk, Lq - s0)
        qc = _acc(q[:, :, s0:s0 + c]).reshape(B, Hkv, G, c, D)
        doc = _acc(do[:, :, s0:s0 + c]).reshape(B, Hkv, G, c, D)
        q_pos = torch.arange(s0, s0 + c, device=q.device) + (Lk - Lq)
        m = _mask(q_pos, k_pos, causal, window)
        s = (qc @ kf.transpose(-1, -2)) * scale        # [B, Hkv, G, c, Lk]
        p = torch.softmax(s.masked_fill(~m, NEG_INF), -1) * m
        dv += (p.transpose(-1, -2) @ doc).sum(2)
        ds = p * (doc @ vf.transpose(-1, -2) - dsum[..., s0:s0 + c, None])
        dq[:, :, s0:s0 + c] = (ds @ kf).reshape(B, Hq, c, D) * scale
        dk += (ds.transpose(-1, -2) @ qc).sum(2) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
