"""Model facade: one interface over every assigned architecture.

Counterpart of ``repro/models/model_zoo.py``.  ``build_model(cfg)``
returns a :class:`Model` exposing

  init_params(generator, device)   random parameters (a seed or a Generator)
  loss_fn(params, batch, remat)    training loss (differentiable)
  init_cache(batch, max_seq)       decode cache
  decode_fn(params, cache, tokens, idx, [enc_out])   one serve step
  prefill(params, tokens, [vision_embeds | frames])  last-token logits

for the dense, moe, ssm, hybrid and vlm families (``transformer``) and
encdec (``encdec``).  The reference's ``abstract_params``,
``abstract_cache``, ``input_specs`` and ``batch_axes`` are not ported:
they give XLA's ``eval_shape`` dry-run its shapes and shardings, which
eager torch has no use for.  Entry points run on CUDA unless
``device="cpu"`` is asked for, and raise where there is no CUDA device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs import ArchConfig
from ..kernels.backend import resolve_device
from . import encdec as ED
from . import transformer as TF


@dataclass
class Model:
    cfg: ArchConfig

    @property
    def encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init_params(self, generator=0, device=None) -> dict:
        """Random parameters on ``device`` (default CUDA), from a
        ``torch.Generator`` on that device or an int seed."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                int(generator))
        if self.encdec:
            return ED.init_encdec(generator, self.cfg, dev)
        return TF.init_lm(generator, self.cfg, dev)

    def loss_fn(self, params, batch, remat: bool = True) -> torch.Tensor:
        """The training loss (f32 scalar) of ``batch``: ``tokens``,
        ``targets`` [B, S], optional ``valid``; ``frames`` [B, T, d]
        (encdec) or ``vision_embeds`` [B, n_vis, d] (vlm).  The reference's
        ``Model.loss_fn``.  ``remat`` recomputes each layer in the backward
        instead of keeping its activations."""
        if self.encdec:
            return ED.encdec_loss(params, self.cfg, batch, remat=remat)
        return TF.lm_loss(params, self.cfg, batch, remat=remat)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        dev = resolve_device(device)
        if self.encdec:
            return ED.encdec_init_cache(self.cfg, batch, max_seq, dev, dtype)
        return TF.init_cache(self.cfg, batch, max_seq, dev, dtype)

    def decode_fn(self, params, cache, tokens, cache_index, enc_out=None):
        """(logits [B, V] f32, cache) for tokens [B, 1] at ``cache_index``
        (a scalar or one position per row); the cache is updated in
        place.  encdec needs ``enc_out`` [B, T, d], the encoder's states
        (:meth:`encode`)."""
        if self.encdec:
            return ED.encdec_decode_step(params, self.cfg, cache, tokens,
                                         cache_index, enc_out)
        return TF.decode_step(params, self.cfg, cache, tokens, cache_index)

    def encode(self, params, frames) -> torch.Tensor:
        """encdec: the encoder's states [B, T, d] of frames [B, T, d]."""
        return ED.encode(params, self.cfg, frames, remat=False)

    def prefill(self, params, tokens, vision_embeds=None,
                frames=None) -> torch.Tensor:
        """Last-position logits [B, V] f32 of prompts tokens [B, S], as the
        reference's dry-run prefill: vlm takes ``vision_embeds``
        [B, n_vis, d] ahead of the tokens; encdec encodes ``frames``
        [B, T, d] first and runs the decoder over the tokens."""
        if self.encdec:
            if frames is None:
                raise ValueError("an encoder-decoder prefill needs frames "
                                 "[B, T, d]")
            return ED.encdec_prefill(params, self.cfg, tokens, frames)
        return TF.prefill(params, self.cfg, tokens, vision_embeds)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
