"""Mixture-of-Experts FFN with GShard-style per-row capacity dropping.

Counterpart of ``repro/models/moe.py``.  The router runs in f32: softmax,
top-k, gates renormalised over the k choices, and the Switch load-balance
auxiliary loss ``E · Σ_e mean_prob_e · mean_choice_e``.  Each (token,
choice) gets a rank within its expert, per batch row (an exclusive
cumulative sum over the row's choices in (token, choice) order); ranks at
or past the capacity ``C = max(1, round(S·k/E · factor))`` are dropped.

The reference dispatches through dense one-hot einsums ([B, S, E, C]
tensors, which XLA shards like any product).  This is the index form of
the same function: every kept choice owns one slot (expert, row, rank) of
an ``[E, B, C, d]`` buffer, so the dispatch is one ``index_copy`` into it,
the experts are batched products over it, and the combine gathers each
choice's slot back and sums the k choices in f32 in a fixed order (a
dropped choice reads a zero row).  The buffer is ``E·B·C·d`` against the
reference's ``B·S·E·C``, no float atomics are needed in either direction
(each slot has one writer; the backward of the gather adds into distinct
slots), and a replayed step gives the same bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init


def init_moe(gen, cfg, device, lead=()):
    """The router f32 ``[d, E]``; experts' ``w1``, ``w3`` ``[E, d, f]`` and
    ``w2`` ``[E, f, d]`` in bf16 (``moe.py:27-37``)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": dense_init(gen, (d, E), device, lead=lead,
                                 dtype=torch.float32),
            "w1": dense_init(gen, (E, d, f), device, lead=lead),
            "w3": dense_init(gen, (E, d, f), device, lead=lead),
            "w2": dense_init(gen, (E, f, d), device, lead=lead)}


def capacity(cfg, S: int, capacity_factor: float = None) -> int:
    """Slots per expert per batch row for S tokens (``moe.py:45``)."""
    cf = capacity_factor or cfg.capacity_factor
    return int(max(1, round(S * cfg.top_k / cfg.n_experts * cf)))


def route(p, x, cfg, capacity_factor: float = None):
    """The router's decisions for x [B, S, d]: ``(gates [B, S, K] f32,
    idx [B, S, K] int64, pos [B, S, K] int64, C, aux)``; a choice is kept
    where ``pos < C``.  Gradients reach the router through the gates and
    the aux loss, never through idx or pos."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S, capacity_factor)
    probs = torch.softmax(x.float() @ p["router"].float(), -1)   # [B, S, E]
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # each row's choices in (token, choice) order, one-hot over experts,
    # experts leading: the running count is a scan along the contiguous
    # last dim (a scan across rows of [B, SK, E] runs its SK steps one
    # after another, at most B·E lanes wide)
    flat = F.one_hot(idx.reshape(B, S * K), E).to(torch.int32)   # [B, SK, E]
    ce = flat.float().mean((0, 1))
    aux = E * (probs.mean((0, 1)) * ce).sum()
    oh = flat.transpose(1, 2).contiguous()                        # [B, E, SK]
    ranks = torch.cumsum(oh, -1, dtype=torch.int32) - oh          # exclusive
    pos = ranks.gather(1, idx.reshape(B, 1, S * K)).reshape(B, S, K)
    return gates, idx, pos, C, aux


def moe_ffn(p, x, cfg, capacity_factor: float = None):
    """x: [B, S, d] -> (y [B, S, d] in x's type, aux f32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, idx, pos, C, aux = route(p, x, cfg, capacity_factor)
    keep = pos < C
    rows = torch.arange(B, device=x.device)[:, None, None]
    n_slots = E * B * C
    # slot (e, b, pos) of the [E, B, C] buffer; a dropped choice goes to a
    # junk row past the end (never read: pos >= C must not index a slot)
    slot = torch.where(keep, (idx * B + rows) * C + pos, n_slots)
    slot = slot.reshape(B * S * K)
    xk = x[:, :, None, :].expand(B, S, K, d).reshape(B * S * K, d)
    xe = x.new_zeros(n_slots + 1, d).index_copy(0, slot, xk)
    xe = xe[:n_slots].view(E, B * C, d)
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"]).view(n_slots, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])                # the junk row: 0
    yk = ye.index_select(0, slot).view(B, S, K, d).float()
    w = (gates * keep).unsqueeze(-1)
    y = (yk * w).sum(2)
    return y.to(x.dtype), aux
