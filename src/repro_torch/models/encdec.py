"""Whisper-style encoder-decoder (the audio front end is a stub).

Counterpart of ``repro/models/encdec.py``.  The encoder takes precomputed
frame embeddings [B, T, d] (the conv stem is a stub, as in the
reference), adds sinusoidal positions and runs bidirectional
self-attention (``causal=False``, q and k roped at positions
``arange(T)``).  The decoder runs causal self-attention, cross-attention
to the encoder's output (no rope, no mask) and the MLP; with a cache it
is one decode step whose self-attention keys go into a ring buffer, as
the decoder-only models' do.  Layers are stacked and run by a Python loop
with each body under :func:`layers.remat_call` when training.
Activations take the parameters' type (bf16 as initialised).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import layers as L
from .transformer import _cache_index, _layer


def _init_enc_block(gen, cfg, device, lead):
    d = cfg.d_model
    return {"ln1": L.ones_init((d,), device, lead),
            "attn": L.init_attention(gen, cfg, device, lead),
            "ln2": L.ones_init((d,), device, lead),
            "mlp": L.init_mlp(gen, cfg, device, lead)}


def _init_dec_block(gen, cfg, device, lead):
    d = cfg.d_model
    return {"ln1": L.ones_init((d,), device, lead),
            "self_attn": L.init_attention(gen, cfg, device, lead),
            "lnx": L.ones_init((d,), device, lead),
            "cross_attn": L.init_attention(gen, cfg, device, lead),
            "ln2": L.ones_init((d,), device, lead),
            "mlp": L.init_mlp(gen, cfg, device, lead)}


def init_encdec(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Random parameters of the reference's tree, shapes and scales
    (``encdec.py:42-57``), all bf16."""
    d = cfg.d_model
    return {
        "embed": L.dense_init(gen, (cfg.vocab, d), device, scale=0.02),
        "enc_layers": _init_enc_block(gen, cfg, device, (cfg.enc_layers,)),
        "enc_ln": L.ones_init((d,), device),
        "dec_layers": _init_dec_block(gen, cfg, device, (cfg.n_layers,)),
        "final_ln": L.ones_init((d,), device),
        "unembed": L.dense_init(gen, (d, cfg.vocab), device, scale=0.02),
    }


def _enc_block(lp, h, cfg, positions):
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + L.attention(lp["attn"], x, cfg, positions, causal=False)
    x = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + L.mlp(lp["mlp"], x)


def encode(params, cfg, frames, remat: bool = True):
    """frames: [B, T, d] stub embeddings -> encoder states [B, T, d].

    As the reference, the frames and the positions are summed in bf16;
    the sum then takes the parameters' type."""
    B, T, d = frames.shape
    dt = params["embed"].dtype
    h = (frames.to(L.BF16) + L.sinusoidal_pos(T, d, frames.device)).to(dt)
    positions = torch.arange(T, device=frames.device)
    for i in range(cfg.enc_layers):
        h = L.remat_call(remat, _enc_block, _layer(params["enc_layers"], i),
                         h, cfg, positions)
    return L.rms_norm(h, params["enc_ln"], cfg.norm_eps)


def cross_kv(lp, cfg, enc_out):
    """A decoder layer's cross-attention keys and values from the encoder
    states: ``(k, v)`` [B, T, KV, hd] each (``encdec.py:80-85``)."""
    B, T, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ lp["cross_attn"]["wk"]).view(B, T, KV, hd)
    v = (enc_out @ lp["cross_attn"]["wv"]).view(B, T, KV, hd)
    return k, v


def _dec_block(lp, h, cfg, positions, enc_out, cache=None, ci=None):
    x = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + L.attention(lp["self_attn"], x, cfg, positions, causal=True,
                        cache=cache, cache_index=ci)
    x = L.rms_norm(h, lp["lnx"], cfg.norm_eps)
    h = h + L.cross_attention(lp["cross_attn"], x, cfg,
                              cross_kv(lp, cfg, enc_out),
                              decode=cache is not None)
    x = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + L.mlp(lp["mlp"], x)


def decode(params, cfg, tokens, enc_out, cache=None, cache_index=None,
           remat: bool = True):
    """tokens: [B, S]; enc_out: [B, T, d].  Returns the final-normed
    hidden [B, S, d].

    Without ``cache``: the teacher-forced decoder over the whole sequence
    (positions ``arange(S)``; the flash-attention kernels run its causal
    self-attention and its cross-attention).  With ``cache`` (see
    :func:`encdec_init_cache`): one decode step at ``cache_index`` (a
    scalar or ``[B]``), the cache updated in place."""
    h = F.embedding(tokens, params["embed"])
    B, S, _ = h.shape
    ar = torch.arange(S, device=h.device)
    ci = None
    if cache is None:
        positions = ar
    else:
        ci = _cache_index(cache_index, B, h.device)
        positions = ci[:, None] + ar
    remat = remat and cache is None
    for i in range(cfg.n_layers):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i]}
        h = L.remat_call(remat, _dec_block, _layer(params["dec_layers"], i),
                         h, cfg, positions, enc_out, c, ci)
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps)


def _unembed(params, h):
    return params["unembed"].to(L.BF16).to(h.dtype)


def encdec_loss(params, cfg, batch, remat: bool = True):
    """batch: ``frames`` [B, T, d], ``tokens`` and ``targets`` [B, S]
    (``valid`` optional).  The decoder's mean NLL (``encdec.py:135``)."""
    enc_out = encode(params, cfg, batch["frames"], remat=remat)
    h = decode(params, cfg, batch["tokens"], enc_out, remat=remat)
    return L.chunked_xent(h, _unembed(params, h), batch["targets"],
                          batch.get("valid"))


def encdec_prefill(params, cfg, tokens, frames):
    """The dry-run's prefill (``repro/launch/dryrun.py:111-114``): encode
    the frames, run the decoder over the tokens, and return the last
    position's logits [B, V] in f32."""
    enc_out = encode(params, cfg, frames, remat=False)
    h = decode(params, cfg, tokens, enc_out, remat=False)
    return (h[:, -1] @ _unembed(params, h)).float()


def encdec_init_cache(cfg, batch: int, max_seq: int, device,
                      dtype=L.BF16):
    """The decoder's self-attention cache of zeros, ``k`` and ``v``
    [n_layers, B, KV, max_seq, hd] (``encdec.py:142-146``)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def encdec_decode_step(params, cfg, cache, tokens, cache_index, enc_out):
    """One decode step against the encoder states ``enc_out``.  tokens:
    [B, 1].  Returns (logits [B, V] f32, cache), the cache updated in
    place."""
    if enc_out is None:
        raise ValueError("an encoder-decoder decode step needs enc_out, "
                         "the encoder's states [B, T, d]")
    h = decode(params, cfg, tokens, enc_out, cache=cache,
               cache_index=cache_index, remat=False)
    return (h[:, -1] @ _unembed(params, h)).float(), cache
