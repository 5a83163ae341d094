"""Core layer primitives over plain dicts of tensors.

Counterpart of ``repro/models/layers.py``.  Every ``init_*`` returns the
reference's parameter tree (the logical-axis trees are sharding metadata
and are not ported) with its shapes and scales; ``lead`` prepends stacked
axes (the layer axis) without changing a parameter's fan-in.

Prefill and training attention run through the flash-attention wrapper:
the CUDA kernels on a CUDA tensor (forward, and the backward kernel where
a gradient is asked for), the query-chunked plain versions on a CPU one.
That covers causal self-attention, the encoder's bidirectional
self-attention and cross-attention (:func:`cross_attention`, both with
``causal=False``).  Decode keeps the reference's ring-buffer cache and its
masks in plain torch (on the TPU too this was left to XLA): the cache is
updated in place, one row per batch element at that row's own position;
a decode step's cross-attention (one query against the encoder's keys)
is plain torch too.  The loss, :func:`chunked_xent`, never holds more
than one chunk's logits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention

NEG_INF = -1e30
BF16 = torch.bfloat16


# ---------------------------------------------------------------- inits ----
def dense_init(gen: torch.Generator, shape, device, scale=None, lead=(),
               dtype=BF16):
    """Normal x fan_in^-0.5 (or ``scale``) in ``dtype`` (bf16 unless asked),
    as ``_dense_init``; fan_in is ``shape[-2]`` (``shape[-1]`` for a
    vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn(tuple(lead) + tuple(shape), generator=gen,
                       device=device, dtype=dtype) * scale


def ones_init(shape, device, lead=(), dtype=BF16):
    return torch.ones(tuple(lead) + tuple(shape), dtype=dtype, device=device)


# ----------------------------------------------------------------- norm ----
def rms_norm(x, w, eps: float = 1e-5):
    """Square in the input type, mean in f32 (``layers.py:36-42``)."""
    var = x.square().float().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


# ----------------------------------------------------------------- rope ----
def rope(x, positions, theta: float = 1e6):
    """x: [..., S, H, hd]; positions: [S] or [B, S] int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def sinusoidal_pos(S: int, d: int, device=None, dtype=BF16):
    """[S, d] positions (``layers.py:61-67``): sin on even columns, cos on
    odd ones, frequencies exp(-9.21034 k / d), computed in f32 and
    rounded to ``dtype`` (bf16, as the reference's)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * (-9.21034 / d))
    pe = torch.zeros(S, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: d - d // 2])
    return pe.to(dtype)


# ------------------------------------------------------------- attention ---
def init_attention(gen, cfg, device, lead=()):
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {"wq": dense_init(gen, (d, H * hd), device, lead=lead),
            "wk": dense_init(gen, (d, KV * hd), device, lead=lead),
            "wv": dense_init(gen, (d, KV * hd), device, lead=lead),
            "wo": dense_init(gen, (H * hd, d), device, lead=lead)}


def attention(p, x, cfg, positions, causal: bool = True,
              window: Optional[int] = None, cache=None, cache_index=None):
    """Self-attention (the reference's ``attention`` without
    ``cross_kv``; :func:`cross_attention` is the rest).  x: [B, S, d].
    Returns [B, S, d].

    Without ``cache`` (prefill, training, the encoder with
    ``causal=False``) the positions are ``arange(S)`` and the
    flash-attention wrapper computes the attention.  With ``cache``
    (decode, S == 1): ``cache = {"k", "v"}`` of ``[B, KV, eff, hd]`` is a
    ring buffer (slot = position % eff) written in place at each row's
    ``cache_index [B]``, and the masks keep slots holding a position in
    ``[0, cache_index]`` (and inside the window)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rope((x @ p["wq"]).view(B, S, H, hd), positions, cfg.rope_theta)
    k = rope((x @ p["wk"]).view(B, S, KV, hd), positions, cfg.rope_theta)
    v = (x @ p["wv"]).view(B, S, KV, hd)
    if cache is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
        return out.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"]
    if S != 1:
        raise ValueError(f"decode takes one token a step, got S={S}")
    kc, vc = cache["k"], cache["v"]
    eff = kc.shape[2]
    ci = cache_index
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(ci, eff)
    kc[rows, :, slot] = k[:, 0].to(kc.dtype)
    vc[rows, :, slot] = v[:, 0].to(vc.dtype)
    j = torch.arange(eff, device=x.device)
    # true position held by slot j: the largest p <= cache_index, p = j mod eff
    tpos = j + torch.div(ci[:, None] - j, eff, rounding_mode="floor") * eff
    spos = positions                                       # [B, S]
    m = (tpos >= 0)[:, None, :]                            # [B, 1, eff]
    if causal:
        m = m & (tpos[:, None, :] <= spos[:, :, None])
    if window is not None:
        m = m & (tpos[:, None, :] > spos[:, :, None] - window)
    return _attend_plain(q, kc, vc, m[:, None, None]) @ p["wo"]


def _attend_plain(q, kc, vc, mask=None):
    """Plain attention of q [B, S, H, hd] over kc, vc [B, KV, T, hd] in
    f32 (GQA: query head h reads kv head h // (H // KV)); ``mask``
    broadcasts against the scores [B, KV, G, S, T].  Returns
    [B, S, H·hd] in q's type."""
    B, S, H, hd = q.shape
    KV = kc.shape[1]
    qg = q.view(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bskgd,bktd->bkgst", qg, kc.float()) * hd ** -0.5
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, -1)
    out = torch.einsum("bkgst,bktd->bskgd", pr, vc.float()).to(q.dtype)
    return out.reshape(B, S, H * hd)


def cross_attention(p, x, cfg, cross_kv, decode: bool = False):
    """The reference's ``attention(..., cross_kv=(k, v))``: queries of x
    [B, S, d] against precomputed keys and values [B, T, KV, hd], with no
    rope on either side and no mask.  The flash-attention wrapper takes it
    with ``causal=False`` (any S against any T); a decode step
    (``decode``, S = 1) runs it in plain torch, as decode's
    self-attention.  Returns [B, S, d]."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).view(B, S, H, hd)
    k, v = cross_kv
    if decode:
        out = _attend_plain(q, k.transpose(1, 2), v.transpose(1, 2))
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False)
        out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p["wo"]


# ----------------------------------------------------------------- mlp -----
def init_mlp(gen, cfg, device, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, (d, f), device, lead=lead),
            "w3": dense_init(gen, (d, f), device, lead=lead),
            "w2": dense_init(gen, (f, d), device, lead=lead)}


def mlp(p, x):
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


# ---------------------------------------------------------------- remat ----
def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant ``torch.utils.checkpoint`` when
    ``remat`` and grad mode is on: its activations are recomputed in the
    backward instead of kept (the layers draw no random numbers, so no
    RNG state is kept)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ------------------------------------------------------------- lm head -----
def _chunk_loss(hh, w, tt, vv):
    logits = (hh @ w).float()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, tt[..., None].long())[..., 0]
    return ((lse - gold) * vv).sum(), vv.sum()


def chunked_xent(h, w_unembed, targets, valid=None, chunk: int = 512):
    """Cross-entropy without holding ``[B, S, V]`` (``layers.py:190``): the
    sequence in chunks of about ``chunk`` positions (the largest count of
    equal chunks that divides S), each chunk's logits in f32.  Under grad
    each chunk runs in ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward instead of kept (the reference's
    ``jax.checkpoint``).

    h: [B, S, d]; w_unembed: [d, V]; targets: [B, S] int; valid: [B, S]
    bool or None.  Returns the mean NLL over valid positions (f32)."""
    B, S, _ = h.shape
    n = max(1, S // chunk)
    while S % n:
        n -= 1
    c = S // n
    vmask = (torch.ones(B, S, dtype=torch.float32, device=h.device)
             if valid is None else valid.float())
    losses, counts = [], []
    for i in range(n):
        nll, cnt = remat_call(True, _chunk_loss, h[:, i * c:(i + 1) * c],
                              w_unembed, targets[:, i * c:(i + 1) * c],
                              vmask[:, i * c:(i + 1) * c])
        losses.append(nll)
        counts.append(cnt)
    return torch.stack(losses).sum() / torch.stack(counts).sum().clamp(min=1)
