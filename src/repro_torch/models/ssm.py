"""Mamba-2 block (SSD, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  Block: in_proj -> [z | xBC | dt];
short causal depthwise conv on xBC; SSD scan over heads; gated RMSNorm(y,
z); out_proj.  Prefill and training run the scan through the SSD-scan
wrapper (the CUDA kernel on a CUDA tensor, the chunked plain version on a
CPU one; its backward is three more scans), with B and C passed as the
one head every head shares and xt, y in the block's own ``[B, S, H, P]``
layout.  Gradients reach the conv, ``softplus(dt + dt_bias)``, ``A_log``,
``D`` and the gated norm through plain autograd.  Decode is the O(1)
recurrent update of the state ``[B, H, N, P]`` and a (K-1)-deep conv tail.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from .layers import BF16, dense_init, ones_init, rms_norm


def init_mamba2(gen, cfg, device, lead=()):
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.conv_kernel
    conv_dim = di + 2 * G * N
    proj_out = 2 * di + 2 * G * N + H   # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, proj_out), device, lead=lead),
        "conv_w": dense_init(gen, (K, conv_dim), device, scale=0.5,
                             lead=lead),
        "A_log": torch.zeros(tuple(lead) + (H,), dtype=f32, device=device),
        "D": ones_init((H,), device, lead, dtype=f32),
        "dt_bias": torch.zeros(tuple(lead) + (H,), dtype=f32, device=device),
        "norm_w": ones_init((di,), device, lead),
        "out_proj": dense_init(gen, (di, d), device, lead=lead),
    }


def mamba2_block(p, x, cfg, state: Optional[dict] = None):
    """x: [B, S, d].  Returns (y, new_state | None).

    state (decode, S == 1): {"ssm": [B, H, N, P] f32, "conv": [B, K-1,
    conv_dim]}."""
    Bsz, S, _ = x.shape
    di, H, N, G, K = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
                      cfg.ssm_groups, cfg.conv_kernel)
    P = cfg.ssm_headdim
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt = zxbcdt[..., -H:]

    new_state = None
    if state is None:
        pad = F.pad(xBC, (0, 0, K - 1, 0))
        conv = pad[:, 0:S] * p["conv_w"][0].to(x.dtype)
        for i in range(1, K):
            conv = conv + pad[:, i: i + S] * p["conv_w"][i].to(x.dtype)
        xBC = F.silu(conv)
    else:
        win = torch.cat([state["conv"], xBC], 1)      # [B, K, conv_dim]
        conv = torch.einsum("bkc,kc->bc", win.float(),
                            p["conv_w"].float())[:, None]
        xBC = F.silu(conv.to(x.dtype))
        new_conv = win[:, 1:]

    xpart = xBC[..., :di].reshape(Bsz, S, H, P)
    Bmat = xBC[..., di: di + G * N].reshape(Bsz, S, G, N)
    Cmat = xBC[..., di + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])           # [B, S, H]
    loga = -torch.exp(p["A_log"]) * dt
    xt = xpart.float() * dt[..., None]

    if state is None:
        # group 0's B and C serve every head (G = 1): passed as one head
        # [B, 1, S, N], read with stride 0; in training the scan's backward
        # sums their per-head gradients over the heads in f32
        y = ssd_scan(xt.transpose(1, 2), loga.transpose(1, 2),
                     Bmat[:, :, 0][:, None], Cmat[:, :, 0][:, None]
                     ).transpose(1, 2)                   # [B, S, H, P] f32
    else:
        b1 = Bmat[:, 0, 0].float()                       # [B, N]
        c1 = Cmat[:, 0, 0].float()
        a1 = torch.exp(loga[:, 0])                       # [B, H]
        S_new = (a1[:, :, None, None] * state["ssm"]
                 + b1[:, None, :, None] * xt[:, 0, :, None, :])
        y = torch.einsum("bn,bhnp->bhp", c1, S_new)[:, None].to(x.dtype)
        new_state = {"ssm": S_new, "conv": new_conv}

    y = y + p["D"].to(x.dtype)[:, None] * xpart
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(x.dtype)), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"]).to(x.dtype), new_state


def init_mamba_state(cfg, batch: int, device, dtype=BF16):
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros(batch, H, N, P, dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(batch, cfg.conv_kernel - 1, conv_dim,
                            dtype=dtype, device=device),
    }
