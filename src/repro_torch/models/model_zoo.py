"""Model facade: one interface over the ported architectures.

Counterpart of ``repro/models/model_zoo.py``.  ``build_model(cfg)``
returns a :class:`Model` exposing

  init_params(generator, device)   random parameters (a seed or a Generator)
  loss_fn(params, batch, remat)    training loss (differentiable)
  init_cache(batch, max_seq)       decode cache
  decode_fn(params, cache, tokens, idx)   one serve step
  prefill(params, tokens)          last-token logits of a whole prompt

Entry points run on CUDA unless ``device="cpu"`` is asked for, and raise
where there is no CUDA device.  The ``moe``, ``vlm`` and ``encdec``
families raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs import ArchConfig
from ..kernels.backend import resolve_device
from . import transformer as TF


@dataclass
class Model:
    cfg: ArchConfig

    def init_params(self, generator=0, device=None) -> dict:
        """Random parameters on ``device`` (default CUDA), from a
        ``torch.Generator`` on that device or an int seed."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                int(generator))
        return TF.init_lm(generator, self.cfg, dev)

    def loss_fn(self, params, batch, remat: bool = True) -> torch.Tensor:
        """The training loss (f32 scalar) of ``batch`` (``tokens``,
        ``targets`` [B, S], optional ``valid``): the reference's
        ``Model.loss_fn``.  ``remat`` recomputes each layer in the
        backward instead of keeping its activations."""
        TF._check_family(self.cfg)
        return TF.lm_loss(params, self.cfg, batch, remat=remat)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None) -> dict:
        return TF.init_cache(self.cfg, batch, max_seq, resolve_device(device),
                             dtype)

    def decode_fn(self, params, cache, tokens, cache_index):
        """(logits [B, V] f32, cache) for tokens [B, 1] at ``cache_index``
        (a scalar or one position per row); the cache is updated in
        place."""
        return TF.decode_step(params, self.cfg, cache, tokens, cache_index)

    def prefill(self, params, tokens) -> torch.Tensor:
        """Last-token logits [B, V] f32 of prompts tokens [B, S]."""
        return TF.prefill(params, self.cfg, tokens)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
