"""Architecture configs: one module per assigned architecture.

A copy of ``repro/configs`` (plain data, no jax), kept here so the port
imports nothing of the reference package.  Each config is an
:class:`ArchConfig`; ``get_config(name)`` resolves by id.  ``SHAPES``
defines the assigned input-shape set (same for every LM arch).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional

ARCH_IDS = [
    "mamba2_130m", "zamba2_1p2b", "whisper_small", "granite_moe_1b",
    "mixtral_8x22b", "mistral_large_123b", "granite_3_8b", "llama3_8b",
    "internlm2_20b", "llava_next_34b",
]

# shape name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_ep: bool = False         # expert-parallel (vs tensor-parallel experts)
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    # --- hybrid (Zamba2-style shared attention block) ---
    attn_every: int = 0          # 0 = no interleaved attention
    # --- attention ---
    window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 1e6
    # --- encoder-decoder (Whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500
    # --- VLM ---
    n_vision_tokens: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def reduced(self, **over) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2), d_model=128,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=256, vocab=512, head_dim=32,
        )
        if self.n_experts:
            # dropless at smoke scale so decode == prefill is exact
            small.update(n_experts=4, top_k=min(self.top_k, 2),
                         capacity_factor=8.0)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16)
        if self.attn_every:
            small.update(attn_every=2, n_layers=4)
        if self.enc_layers:
            small.update(enc_layers=2, enc_seq=16)
        if self.n_vision_tokens:
            small.update(n_vision_tokens=8)
        if self.window:
            small.update(window=32)
        small.update(over)
        return replace(self, **small)


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "p")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f".{key}", __package__)
    return mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §5)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True
