"""The LM stack for serving: dense, ssm and hybrid families, prefill and
decode.  Counterpart of ``repro/models``."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
