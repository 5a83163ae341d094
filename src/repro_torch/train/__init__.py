"""Training: AdamW, the microbatched train step and int8 gradient
compression.  Counterpart of ``repro/train``."""
from .optimizer import adamw_init, adamw_update
from .train_step import make_train_step

__all__ = ["adamw_init", "adamw_update", "make_train_step"]
