"""The model stack: the dense, moe, ssm, hybrid, vlm and encdec families,
prefill, decode and training loss.  Counterpart of ``repro/models``."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
