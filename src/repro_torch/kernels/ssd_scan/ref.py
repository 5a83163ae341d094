"""Plain PyTorch versions of the SSD scan (Mamba-2, arXiv:2405.21060).

Counterparts of ``repro/kernels/ssd_scan/ref.py`` (the per-token
recurrence, :func:`ssd_scan_ref`, kept as a test oracle) and of
``repro/models/ssm.py:_ssd_chunked`` (the chunked block decomposition,
:func:`ssd_chunked_ref`, the CUDA kernel's plain version), and the CUDA
kernel's three passes written out (:func:`ssd_chunk_parallel_ref`).

Shapes: the model's ``xt [b, H, L, P]``, ``loga [b, H, L]``,
``B/C [b, H, L, N]``, where B/C may be a stride-0 ``expand`` along H (the
model's B and C are shared by all heads).  Math in float32; the output is
in xt's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 64   # the CUDA kernel's chunk; chunking does not change the function


def _shared_heads(t: torch.Tensor) -> torch.Tensor:
    """[b, H, L, N] -> [b, 1, L, N] when H is a stride-0 broadcast, so the
    plain version never materializes the per-head copies."""
    return t[:, :1] if t.shape[1] > 1 and t.stride(1) == 0 else t


def ssd_scan_ref(xt, loga, B, C):
    """The per-token recurrence S_t = exp(loga_t) S_{t-1} + B_t ⊗ xt_t,
    y_t = C_t S_t, one Python step per token (slow: a test oracle)."""
    b, H, L, P = xt.shape
    N = B.shape[-1]
    x, la = xt.float(), loga.float()
    Bf, Cf = _shared_heads(B).float(), _shared_heads(C).float()
    S = torch.zeros(b, H, N, P, dtype=torch.float32, device=xt.device)
    ys = []
    for t in range(L):
        S = (torch.exp(la[:, :, t])[..., None, None] * S
             + Bf[:, :, t, :, None] * x[:, :, t, None, :])
        ys.append((Cf[:, :, t, None, :] @ S)[..., 0, :])
    y = torch.stack(ys, 2) if ys else x.new_zeros(b, H, 0, P)
    return y.to(xt.dtype)


def ssd_chunked_ref(xt, loga, B, C, chunk: int = CHUNK):
    """The chunked form, chunk by chunk with the f32 state ``S [N, P]``
    carried in order:

        y  = (C ∘ exp(l)) @ S + (tril(C Bᵀ) ∘ exp(l_i - l_j)) @ xt
        S <- exp(l_Q) S + (B ∘ exp(l_Q - l))ᵀ @ xt

    with ``l`` the in-chunk inclusive cumsum of ``loga``.  A ragged last
    chunk is zero-padded (``loga`` 0, so the padding moves nothing)."""
    b, H, L, P = xt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-L // Q)
    pad = nc * Q - L
    x = F.pad(xt.float(), (0, 0, 0, pad)).view(b, H, nc, Q, P)
    la = F.pad(loga.float(), (0, pad)).view(b, H, nc, Q)
    Bs, Cs = _shared_heads(B), _shared_heads(C)
    Bf = F.pad(Bs.float(), (0, 0, 0, pad)).view(b, Bs.shape[1], nc, Q, N)
    Cf = F.pad(Cs.float(), (0, 0, 0, pad)).view(b, Cs.shape[1], nc, Q, N)
    ii = torch.arange(Q, device=xt.device)
    tril = ii[:, None] >= ii[None, :]
    S = torch.zeros(b, H, N, P, dtype=torch.float32, device=xt.device)
    ys = []
    for c in range(nc):
        xq, bq, cq = x[:, :, c], Bf[:, :, c], Cf[:, :, c]
        l = torch.cumsum(la[:, :, c], -1)                      # [b, H, Q]
        y_inter = (cq @ S) * torch.exp(l)[..., None]
        dec = torch.where(tril, torch.exp(l[..., :, None] - l[..., None, :]),
                          0.0)
        y_intra = ((cq @ bq.transpose(-1, -2)) * dec) @ xq
        ltot = l[..., -1:]                                     # [b, H, 1]
        bdec = bq * torch.exp(ltot - l)[..., None]             # [b, H, Q, N]
        S = torch.exp(ltot)[..., None] * S + bdec.transpose(-1, -2) @ xq
        ys.append(y_inter + y_intra)
    return torch.stack(ys, 2).view(b, H, nc * Q, P)[:, :, :L].to(xt.dtype)


def ssd_chunk_parallel_ref(xt, loga, B, C, chunk: int = CHUNK):
    """The chunked form as the CUDA kernel splits it (Mamba-2 §7), in three
    passes that each run over all chunks at once but the second:

        1. chunk states  s_c = (B ∘ exp(l_Q - l))ᵀ @ xt       [N, P]
        2. state passing S_c = exp(l_Q,c) S_{c-1} + s_c, chunk by chunk
        3. outputs       y = exp(l) ∘ (C @ S_{c-1})
                             + (tril(C Bᵀ) ∘ exp(l_i - l_j)) @ xt

    Same function as :func:`ssd_chunked_ref`; only the order of the work
    differs.  A ragged last chunk is zero-padded (``loga`` 0)."""
    b, H, L, P = xt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-L // Q)
    pad = nc * Q - L
    x = F.pad(xt.float(), (0, 0, 0, pad)).view(b, H, nc, Q, P)
    la = F.pad(loga.float(), (0, pad)).view(b, H, nc, Q)
    Bs, Cs = _shared_heads(B), _shared_heads(C)
    Bf = F.pad(Bs.float(), (0, 0, 0, pad)).view(b, Bs.shape[1], nc, Q, N)
    Cf = F.pad(Cs.float(), (0, 0, 0, pad)).view(b, Cs.shape[1], nc, Q, N)
    l = torch.cumsum(la, -1)                                   # [b,H,nc,Q]
    ltot = l[..., -1:]
    s = (Bf * torch.exp(ltot - l)[..., None]).transpose(-1, -2) @ x
    S = torch.zeros(b, H, N, P, dtype=torch.float32, device=xt.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = torch.exp(ltot[:, :, c])[..., None] * S + s[:, :, c]
    S_prev = torch.stack(prev, 2)                              # [b,H,nc,N,P]
    ii = torch.arange(Q, device=xt.device)
    dec = torch.where(ii[:, None] >= ii[None, :],
                      torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    y = (torch.exp(l)[..., None] * (Cf @ S_prev)
         + ((Cf @ Bf.transpose(-1, -2)) * dec) @ x)
    return y.reshape(b, H, nc * Q, P)[:, :, :L].to(xt.dtype)
