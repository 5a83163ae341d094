"""Plain PyTorch versions of the SSD scan (Mamba-2, arXiv:2405.21060).

Counterparts of ``repro/kernels/ssd_scan/ref.py`` (the per-token
recurrence, :func:`ssd_scan_ref`, kept as a test oracle) and of
``repro/models/ssm.py:_ssd_chunked`` (the chunked block decomposition,
:func:`ssd_chunked_ref`, the CUDA kernel's plain version), the CUDA
kernel's three passes written out (:func:`ssd_chunk_parallel_ref`), and
the backward as three more scans (:func:`ssd_scan_backward_ref`; the
reference differentiates its jnp scan instead) and the backward kernel's
passes written out (:func:`ssd_backward_chunk_parallel_ref`).

Shapes: ``xt [b, H, L, P]``, ``loga [b, H, L]``, ``B/C [b, H, L, N]``
(any strides, a stride-0 ``expand`` along H included) or
``[b, 1, L, N]``, one group shared by every head, as the model passes
them.  Math in float32 (float64 for float64 inputs); the output is in
xt's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import HEAD_GROUP

CHUNK = 64   # the CUDA kernel's chunk; chunking does not change the function


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the math runs in: f32, or f64 for f64 input."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _shared_heads(t: torch.Tensor) -> torch.Tensor:
    """[b, H, L, N] -> [b, 1, L, N] when H is a stride-0 broadcast, so the
    plain version never materializes the per-head copies."""
    return t[:, :1] if t.shape[1] > 1 and t.stride(1) == 0 else t


def ssd_scan_ref(xt, loga, B, C):
    """The per-token recurrence S_t = exp(loga_t) S_{t-1} + B_t ⊗ xt_t,
    y_t = C_t S_t, one Python step per token (slow: a test oracle)."""
    b, H, L, P = xt.shape
    N = B.shape[-1]
    x, la = _acc(xt), _acc(loga)
    Bf, Cf = _acc(_shared_heads(B)), _acc(_shared_heads(C))
    S = torch.zeros(b, H, N, P, dtype=x.dtype, device=xt.device)
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
    x = F.pad(_acc(xt), (0, 0, 0, pad)).view(b, H, nc, Q, P)
    la = F.pad(_acc(loga), (0, pad)).view(b, H, nc, Q)
    Bs, Cs = _shared_heads(B), _shared_heads(C)
    Bf = F.pad(_acc(Bs), (0, 0, 0, pad)).view(b, Bs.shape[1], nc, Q, N)
    Cf = F.pad(_acc(Cs), (0, 0, 0, pad)).view(b, Cs.shape[1], nc, Q, N)
    ii = torch.arange(Q, device=xt.device)
    tril = ii[:, None] >= ii[None, :]
    S = torch.zeros(b, H, N, P, dtype=x.dtype, device=xt.device)
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


def _heads(t: torch.Tensor, H: int, dtype, flip: bool) -> torch.Tensor:
    """``t`` [b, H, L, N] or [b, 1, L, N] as [b, H, L, N] in ``dtype``,
    reversed in time if ``flip``; B or C shared by the heads (one head, or
    a stride-0 broadcast) is cast and flipped once and read with stride 0
    over the heads."""
    s = _shared_heads(t).to(dtype)
    if flip:
        s = s.flip(2)
    return s.expand(t.shape[0], H, *t.shape[2:])


def ssd_scan_backward_ref(xt, loga, B, C, y, dy):
    """Gradients ``(dxt, dloga, dB, dC)`` of the scan ``y = ssd(xt, loga,
    B, C)`` given ``dy`` = dL/dy and the forward's ``y``, as three more
    forward scans (``ssd``: :func:`ssd_chunked_ref`) and one reverse
    cumulative sum.  With ``flip`` the reversal of time and ``a⁺_t =
    loga_{t+1}`` (``a⁺_{L-1} = 0``):

        dxt   = flip(ssd(flip(dy), flip(a⁺), flip(C), flip(B)))
        dB    = flip(ssd(flip(C), flip(a⁺), flip(dy), flip(xt)))
        dC    = ssd(B, loga, xt, dy)
        dloga = reverse_cumsum_t(<y_t, dy_t> - <xt_t, dxt_t>)

    (the adjoint recurrence G_t = exp(a_{t+1}) G_{t+1} + C_t ⊗ dy_t, with
    dxt_t = B_t G_t, is a forward scan in reversed time; for dB the roles
    of P and N swap).  dB and dC are shaped like B and C: where these are
    one group shared by every head (``[b, 1, L, N]``), the per-head scans'
    outputs are summed over the heads here, in the math's type, as the
    reference's gradient through its broadcast is; a ``[b, H, L, N]`` B or
    C, a stride-0 expand included, gets its per-head gradient.  Results in
    the math's type (f32, f64 for f64 inputs)."""
    f = torch.promote_types(xt.dtype, torch.float32)
    H = xt.shape[1]
    x, la = _acc(xt), _acc(loga)
    dy = _acc(dy)
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    a_next = F.pad(la[..., 1:], (0, 1)).flip(-1)   # flip(a⁺)
    dyf = dy.flip(2)
    bc = f if B.dtype == torch.float64 else B.dtype  # the scan's B/C type
    dxt = ssd_chunked_ref(dyf, a_next, _heads(C, H, bc, True),
                          _heads(B, H, bc, True)).flip(2)
    dB = ssd_chunked_ref(_heads(C, H, f, True), a_next, dyf,
                         x.flip(2)).flip(2)
    dC = ssd_chunked_ref(_heads(B, H, f, False), la, x, dy)
    if B.shape[1] != H:
        dB = dB.sum(1, keepdim=True)
    if C.shape[1] != H:
        dC = dC.sum(1, keepdim=True)
    dloga = ((_acc(y) * dy).sum(-1) - (x * dxt).sum(-1)).flip(-1).cumsum(
        -1).flip(-1)
    return dxt, dloga, dB, dC


def ssd_backward_chunk_parallel_ref(xt, loga, B, C, y, dy,
                                    chunk: int = CHUNK):
    """The gradients of :func:`ssd_scan_backward_ref` in the order the CUDA
    backward (``csrc/ssd_scan_bwd.cu``) computes them, Mamba-2's chunked
    backward with ``l`` the in-chunk inclusive cumsum of ``loga``:

        1. chunk states, both ways:  s_c = (B ∘ exp(l_Q - l))ᵀ @ xt and
           g_c = (C ∘ exp(l))ᵀ @ dy                           [N, P]
        2. state passes:  S_c = exp(l_Q,c) S_{c-1} + s_c forward, and the
           adjoint entering chunk c from the right, H_{c-1} =
           exp(l_Q,c) H_c + g_c backward (H of the last chunk 0)
        3. per chunk, with V = tril(dy xtᵀ) ∘ exp(l_i - l_j) and
           W = tril(C Bᵀ) ∘ exp(l_i - l_j):
              dxt = exp(l_Q - l) ∘ (B @ H_c) + Wᵀ @ dy
              dB  = exp(l_Q - l) ∘ (xt @ H_cᵀ) + Vᵀ @ C
              dC  = exp(l) ∘ (dy @ S_{c-1}ᵀ) + V @ B
              dloga's in-chunk reverse cumsum of <y, dy> - <xt, dxt>
        4. dloga plus the totals of the later chunks; dB, dC of a B or C
           shared by the heads summed over groups of HEAD_GROUP heads, then
           over the groups in order.

    The kernel does 1 and 2 in one walk a head and direction, chunk by
    chunk in this order.  Same function as :func:`ssd_scan_backward_ref`;
    only the order of the work differs.  A ragged last chunk is
    zero-padded (``loga`` 0).  Results in the math's type (f32, f64 for
    f64 inputs), dB and dC shaped like B and C as
    :func:`ssd_scan_backward_ref`'s."""
    b, H, L, P = xt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t, width):
        return F.pad(_acc(t), (0, 0, 0, pad)).view(b, t.shape[1], nc, Q,
                                                   width)
    x, d, yy = chunks(xt, P), chunks(dy, P), chunks(y, P)
    Bf, Cf = chunks(_shared_heads(B), N), chunks(_shared_heads(C), N)
    la = F.pad(_acc(loga), (0, pad)).view(b, H, nc, Q)
    l = torch.cumsum(la, -1)                                   # [b,H,nc,Q]
    ltot = l[..., -1:]
    wq = torch.exp(ltot - l)[..., None]                        # exp(l_Q - l)
    el = torch.exp(l)[..., None]
    # 1. chunk states
    s = (Bf * wq).transpose(-1, -2) @ x                        # [b,H,nc,N,P]
    g = (Cf * el).transpose(-1, -2) @ d
    # 2. state passes
    S = torch.zeros(b, H, N, P, dtype=x.dtype, device=xt.device)
    Hc = torch.zeros_like(S)
    prev, nxt = [], [None] * nc
    for c in range(nc):
        prev.append(S)
        S = torch.exp(ltot[:, :, c])[..., None] * S + s[:, :, c]
    for c in reversed(range(nc)):
        nxt[c] = Hc
        Hc = torch.exp(ltot[:, :, c])[..., None] * Hc + g[:, :, c]
    S_prev, H_next = torch.stack(prev, 2), torch.stack(nxt, 2)
    # 3. per chunk
    ii = torch.arange(Q, device=xt.device)
    dec = torch.where(ii[:, None] >= ii[None, :],
                      torch.exp(l[..., :, None] - l[..., None, :]), 0.0)
    W = (Cf @ Bf.transpose(-1, -2)) * dec                      # [.., s, t]
    V = (d @ x.transpose(-1, -2)) * dec                        # [.., i, j]
    dx = wq * (Bf @ H_next) + W.transpose(-1, -2) @ d
    dB = wq * (x @ H_next.transpose(-1, -2)) + V.transpose(-1, -2) @ Cf
    dC = el * (d @ S_prev.transpose(-1, -2)) + V @ Bf
    r = ((yy * d).sum(-1) - (x * dx).sum(-1)).flip(-1).cumsum(-1).flip(-1)
    # 4. the later chunks' totals; the group sums
    tot = r[..., 0]                                            # [b,H,nc]
    later = tot.flip(-1).cumsum(-1).flip(-1) - tot
    dloga = (r + later[..., None]).reshape(b, H, nc * Q)[..., :L]

    def finish(t, like):
        t = t.reshape(b, H, nc * Q, N)[:, :, :L]
        if like.shape[1] == H:
            return t
        parts = [t[:, h:h + HEAD_GROUP].sum(1, keepdim=True)
                 for h in range(0, H, HEAD_GROUP)]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out
    dxt = dx.reshape(b, H, nc * Q, P)[:, :, :L]
    return dxt, dloga, finish(dB, B), finish(dC, C)
