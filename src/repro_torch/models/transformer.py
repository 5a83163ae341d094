"""Decoder-only LM for the dense, ssm and hybrid families.

Counterpart of ``repro/models/transformer.py``.  Layers are STACKED on a
leading axis, as in the reference, and run by a Python loop (the
reference's ``lax.scan``).  With ``remat`` (training: no cache, grad mode
on) each layer body runs under ``torch.utils.checkpoint`` and is run again
in the backward instead of keeping its activations, as the reference's
``jax.checkpoint`` around its scan bodies; so is the hybrid's shared
block.  Hybrid (Zamba2-style) models run the Mamba layers in segments of
``attn_every`` with ONE shared attention+FFN block after each full
segment.  The decode cache is updated in place: ``decode_step`` returns
the same dict it was given.  Activations take the parameters' type (bf16
as initialised, like the reference; a float32 copy of the weights runs
the same code in float32).  ``moe`` and ``vlm`` are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import layers as L
from .ssm import init_mamba2, init_mamba_state, mamba2_block

_NOT_PORTED = ("the {} family is not ported yet (ROADMAP.md, queue 1 "
               "item 9)")


def _check_family(cfg):
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(_NOT_PORTED.format(cfg.family))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ init ---
def _init_block(gen, cfg, device, lead):
    d = cfg.d_model
    if cfg.family == "dense":
        return {"ln1": L.ones_init((d,), device, lead),
                "attn": L.init_attention(gen, cfg, device, lead),
                "ln2": L.ones_init((d,), device, lead),
                "mlp": L.init_mlp(gen, cfg, device, lead)}
    return {"ln1": L.ones_init((d,), device, lead),
            "mamba": init_mamba2(gen, cfg, device, lead)}


def init_lm(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Random parameters of the reference's shapes and scales, bf16 apart
    from the Mamba blocks' f32 ``A_log``, ``D`` and ``dt_bias``."""
    _check_family(cfg)
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
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + L.attention(p["attn"], x, cfg, positions, causal=True,
                        window=cfg.window, cache=cache,
                        cache_index=cache_index)
    x = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    return h + L.mlp(p["mlp"], x)


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


def forward(params, cfg, tokens, cache=None, cache_index=None,
            remat: bool = True):
    """tokens: [B, S] int.  Returns the final-normed hidden [B, S, d].

    Without ``cache`` this is the prefill or the training forward
    (positions ``arange(S)``; the attention and SSD kernels run here);
    ``remat`` checkpoints each layer body when grad mode is on.  With
    ``cache`` (see :func:`init_cache`) it is one decode step at
    ``cache_index`` (a scalar or one position per row, ``[B]``), and
    ``cache`` is updated in place.
    """
    _check_family(cfg)
    # a gather whose backward sums rows without float atomics
    h = F.embedding(tokens, params["embed"])
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

    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            c = None if cache is None else {"k": cache["k"][i],
                                            "v": cache["v"][i]}
            h = L.remat_call(remat, _attn_block, _layer(layers, i), h,
                             cfg, positions, c, ci)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = L.remat_call(remat, _mamba_layer, _layer(layers, i), h,
                             cfg, cache, i)
    else:   # hybrid: segments of attn_every Mamba layers + the shared block
        k = cfg.attn_every
        for s in range(-(-cfg.n_layers // k)):
            lo, hi = s * k, min((s + 1) * k, cfg.n_layers)
            for i in range(lo, hi):
                h = L.remat_call(remat, _mamba_layer, _layer(layers, i),
                                 h, cfg, cache, i)
            if hi == (s + 1) * k:   # a full segment: the shared block
                c = None if cache is None else {"k": cache["shared_k"][s],
                                                "v": cache["shared_v"][s]}
                h = L.remat_call(remat, _attn_block, params["shared"], h,
                                 cfg, positions, c, ci)
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps)


def _logits(params, cfg, h):
    """Last-token logits [B, V] in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (h[:, -1] @ w.to(h.dtype)).float()


def prefill(params, cfg, tokens):
    """The dry-run's prefill (``repro/launch/dryrun.py:109-121``): the
    forward over the whole prompt, then the last token's logits
    ``[B, V]`` in f32."""
    return _logits(params, cfg, forward(params, cfg, tokens, remat=False))


# ------------------------------------------------------------------ loss ---
def lm_loss(params, cfg, batch, remat: bool = True):
    """Training loss (``transformer.py:216``): batch ``tokens`` and
    ``targets`` [B, S] (``valid`` [B, S] bool optional).  The mean NLL of
    :func:`layers.chunked_xent` plus 0.01 times the auxiliary loss, which
    is 0 here (it is the MoE router's, and ``moe`` is not ported).  The
    unembedding is rounded to bf16 whatever the weights' type, as the
    reference's, and enters the product in ``h``'s type."""
    h = forward(params, cfg, batch["tokens"], remat=remat)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    nll = L.chunked_xent(h, w.to(L.BF16).to(h.dtype), batch["targets"],
                         batch.get("valid"))
    aux = 0.0
    return nll + 0.01 * aux


# ----------------------------------------------------------------- cache ---
def init_cache(cfg, batch: int, max_seq: int, device, dtype=L.BF16):
    """Decode cache of zeros.  Sliding-window attention caps the ring at
    the window (decode never reads past it)."""
    _check_family(cfg)
    eff = min(max_seq, cfg.window) if cfg.window else max_seq
    if cfg.family == "dense":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, eff, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
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
