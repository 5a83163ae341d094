"""Plain PyTorch versions of flash attention.

Counterparts of ``repro/kernels/flash_attention/ref.py:attention_ref``
(the full score matrix, a test oracle) and of
``repro/models/layers.py:_sdpa_chunked`` (query-chunked attention, the
CUDA kernel's plain version: a full ``[L, L]`` score matrix would not fit
at 32k tokens).  Queries align to the END of the keys: query i attends
key positions ``<= Lk - Lq + i`` (causal) and ``> Lk - Lq + i - window``
(sliding window).  Math in float32; the output is in q's type.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
CHUNK = 512


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
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / D ** 0.5)
    m = _mask(torch.arange(Lq, device=q.device) + (Lk - Lq),
              torch.arange(Lk, device=q.device), causal, window)
    s = s.masked_fill(~m, NEG_INF)
    return (torch.softmax(s, -1) @ v.float()).to(q.dtype)


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
    kf = k.float()[:, :, None].transpose(-1, -2)      # [B, Hkv, 1, D, Lk]
    vf = v.float()[:, :, None]                        # [B, Hkv, 1, Lk, D]
    k_pos = torch.arange(Lk, device=q.device)
    out = torch.empty(B, Hq, Lq, D, dtype=q.dtype, device=q.device)
    for s0 in range(0, Lq, chunk):
        c = min(chunk, Lq - s0)
        qc = q[:, :, s0:s0 + c].float().reshape(B, Hkv, G, c, D)
        s = (qc @ kf) * (1.0 / D ** 0.5)               # [B, Hkv, G, c, Lk]
        q_pos = torch.arange(s0, s0 + c, device=q.device) + (Lk - Lq)
        m = _mask(q_pos, k_pos, causal, window)
        o = torch.softmax(s.masked_fill(~m, NEG_INF), -1) @ vf
        o = torch.where(m.any(-1)[:, None], o, 0.0)
        out[:, :, s0:s0 + c] = o.reshape(B, Hq, c, D).to(q.dtype)
    return out
