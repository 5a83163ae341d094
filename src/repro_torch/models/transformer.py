"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families.

Counterpart of ``repro/models/transformer.py``.  Layers are STACKED on a
leading axis, as in the reference, and run by a Python loop (the
reference's ``lax.scan``).  With ``remat`` (training: no cache, grad mode
on) each layer body runs under ``torch.utils.checkpoint`` and is run again
in the backward instead of keeping its activations, as the reference's
``jax.checkpoint`` around its scan bodies; so is the hybrid's shared
block.  Hybrid (Zamba2-style) models run the Mamba layers in segments of
``attn_every`` with ONE shared attention+FFN block after each full
segment.  ``moe`` blocks replace the MLP by :func:`moe.moe_ffn`, whose
auxiliary loss the forward sums over the layers; ``vlm`` is the dense
stack with stub vision embeddings placed ahead of the tokens.  The decode
cache is updated in place: ``decode_step`` returns the same dict it was
given.  Activations take the parameters' type (bf16 as initialised, like
the reference; a float32 copy of the weights runs the same code in
float32).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import layers as L
from .moe import init_moe, moe_ffn
from .ssm import init_mamba2, init_mamba_state, mamba2_block

ATTN_FAMILIES = ("dense", "moe", "vlm")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ init ---
def _init_block(gen, cfg, device, lead):
    d = cfg.d_model
    if cfg.family in ATTN_FAMILIES:
        p = {"ln1": L.ones_init((d,), device, lead),
             "attn": L.init_attention(gen, cfg, device, lead),
             "ln2": L.ones_init((d,), device, lead)}
        if cfg.family == "moe":
            p["moe"] = init_moe(gen, cfg, device, lead)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, device, lead)
        return p
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"not a decoder-only family: {cfg.family}")
    return {"ln1": L.ones_init((d,), device, lead),
            "mamba": init_mamba2(gen, cfg, device, lead)}


def init_lm(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Random parameters of the reference's shapes and scales, bf16 apart
    from the Mamba blocks' f32 ``A_log``, ``D`` and ``dt_bias`` and the
    MoE router (f32)."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": L.dense_init(gen, (cfg.vocab, d), device, scale=0.02),
        "layers": _init_block(gen, cfg, device, (cfg.n_layers,)),
        "final_ln": L.ones_init((d,), device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(gen, (d, cfg.vocab), device, scale=0.02)
    if cfg.family == "hybrid":
        p["shared"] = {"ln1": L.ones_init((d,), device),
                       "attn": L.init_attention(gen, cfg, device),
                       "ln2": L.ones_init((d,), device),
                       "mlp": L.init_mlp(gen, cfg, device)}
    return p


# --------------------------------------------------------------- forward ---
def _attn_block(p, h, cfg, positions, cache=None, cache_index=None):
    """(h, aux): the block's output and its MoE auxiliary loss (0 for an
    MLP block)."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + L.attention(p["attn"], x, cfg, positions, causal=True,
                        window=cfg.window, cache=cache,
                        cache_index=cache_index)
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_ffn(p["moe"], x, cfg)
    else:
        y, aux = L.mlp(p["mlp"], x), h.new_zeros((), dtype=torch.float32)
    return h + y, aux


def _mamba_layer(p, h, cfg, cache=None, i=None):
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    state = None if cache is None else {"ssm": cache["ssm"][i],
                                        "conv": cache["conv"][i]}
    y, ns = mamba2_block(p["mamba"], x, cfg, state=state)
    if cache is not None:
        cache["ssm"][i] = ns["ssm"]
        cache["conv"][i] = ns["conv"]
    return h + y


def _cache_index(cache_index, B: int, device) -> torch.Tensor:
    """A scalar or per-row ``[B]`` cache index as an int64 ``[B]``."""
    ci = torch.as_tensor(cache_index, device=device).to(torch.int64)
    return ci.expand(B) if ci.dim() == 0 else ci


def forward(params, cfg, tokens, vision_embeds=None, cache=None,
            cache_index=None, remat: bool = True):
    """tokens: [B, S] int.  Returns the final-normed hidden [B, S', d];
    :func:`forward_aux` also returns the summed MoE auxiliary loss."""
    return forward_aux(params, cfg, tokens, vision_embeds, cache,
                       cache_index, remat)[0]


def forward_aux(params, cfg, tokens, vision_embeds=None, cache=None,
                cache_index=None, remat: bool = True):
    """The reference's ``forward``: ``(hidden [B, S', d], aux)``, aux the
    f32 sum over the layers of the MoE auxiliary loss (0 without MoE).

    ``vision_embeds`` [B, n_vis, d] (vlm prefill and training) go ahead of
    the tokens' embeddings, S' = n_vis + S, with positions over the whole
    sequence.  Without ``cache`` this is the prefill or the training
    forward (positions ``arange(S')``; the attention and SSD kernels run
    here); ``remat`` checkpoints each layer body when grad mode is on.
    With ``cache`` (see :func:`init_cache`) it is one decode step at
    ``cache_index`` (a scalar or one position per row, ``[B]``), and
    ``cache`` is updated in place.
    """
    # a gather whose backward sums rows without float atomics
    h = F.embedding(tokens, params["embed"])
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(h.dtype), h], 1)
    B, S, _ = h.shape
    ar = torch.arange(S, device=h.device)
    ci = None
    remat = remat and cache is None
    if cache is None:
        positions = ar
    else:
        ci = _cache_index(cache_index, B, h.device)
        positions = ci[:, None] + ar
    layers = params["layers"]
    aux = h.new_zeros((), dtype=torch.float32)

    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            c = None if cache is None else {"k": cache["k"][i],
                                            "v": cache["v"][i]}
            h, a = L.remat_call(remat, _attn_block, _layer(layers, i), h,
                                cfg, positions, c, ci)
            aux = aux + a
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = L.remat_call(remat, _mamba_layer, _layer(layers, i), h,
                             cfg, cache, i)
    elif cfg.family == "hybrid":   # attn_every Mamba layers + shared block
        k = cfg.attn_every
        for s in range(-(-cfg.n_layers // k)):
            lo, hi = s * k, min((s + 1) * k, cfg.n_layers)
            for i in range(lo, hi):
                h = L.remat_call(remat, _mamba_layer, _layer(layers, i),
                                 h, cfg, cache, i)
            if hi == (s + 1) * k:   # a full segment: the shared block
                c = None if cache is None else {"k": cache["shared_k"][s],
                                                "v": cache["shared_v"][s]}
                h, a = L.remat_call(remat, _attn_block, params["shared"],
                                    h, cfg, positions, c, ci)
                aux = aux + a
    else:
        raise ValueError(f"not a decoder-only family: {cfg.family}")
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def _logits(params, cfg, h):
    """Last-token logits [B, V] in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (h[:, -1] @ w.to(h.dtype)).float()


def prefill(params, cfg, tokens, vision_embeds=None):
    """The dry-run's prefill (``repro/launch/dryrun.py:109-121``): the
    forward over the whole prompt (vision embeddings first, for vlm),
    then the last position's logits ``[B, V]`` in f32."""
    return _logits(params, cfg, forward(params, cfg, tokens, vision_embeds,
                                        remat=False))


# ------------------------------------------------------------------ loss ---
def lm_loss(params, cfg, batch, remat: bool = True):
    """Training loss (``transformer.py:216``): batch ``tokens`` and
    ``targets`` [B, S] (``valid`` [B, S] bool optional; ``vision_embeds``
    [B, n_vis, d] for vlm, whose positions take no loss).  The mean NLL of
    :func:`layers.chunked_xent` on the text positions plus 0.01 times the
    auxiliary loss (the MoE routers', summed over the layers; 0
    otherwise).  The unembedding is rounded to bf16 whatever the weights'
    type, as the reference's, and enters the product in ``h``'s type."""
    ve = batch.get("vision_embeds")
    h, aux = forward_aux(params, cfg, batch["tokens"], ve, remat=remat)
    if ve is not None:
        h = h[:, ve.shape[1]:]          # the loss on text positions only
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    nll = L.chunked_xent(h, w.to(L.BF16).to(h.dtype), batch["targets"],
                         batch.get("valid"))
    return nll + 0.01 * aux


# ----------------------------------------------------------------- cache ---
def init_cache(cfg, batch: int, max_seq: int, device, dtype=L.BF16):
    """Decode cache of zeros.  Sliding-window attention caps the ring at
    the window (decode never reads past it)."""
    eff = min(max_seq, cfg.window) if cfg.window else max_seq
    if cfg.family in ATTN_FAMILIES:
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, eff, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"not a decoder-only family: {cfg.family}")
    st = init_mamba_state(cfg, batch, device, dtype)
    cache = {n: torch.zeros((cfg.n_layers,) + t.shape, dtype=t.dtype,
                            device=device) for n, t in st.items()}
    if cfg.family == "hybrid":
        kshape = (cfg.n_layers // cfg.attn_every, batch, cfg.n_kv_heads,
                  eff, cfg.hd)
        cache["shared_k"] = torch.zeros(kshape, dtype=dtype, device=device)
        cache["shared_v"] = torch.zeros(kshape, dtype=dtype, device=device)
    return cache


def decode_step(params, cfg, cache, tokens, cache_index):
    """One decode step.  tokens: [B, 1]; cache_index: a scalar or ``[B]``.
    Returns (logits [B, V] f32, cache), the cache updated in place."""
    h = forward(params, cfg, tokens, cache=cache, cache_index=cache_index,
                remat=False)
    return _logits(params, cfg, h), cache
