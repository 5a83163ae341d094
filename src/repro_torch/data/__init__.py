from .pipeline import GlobalOrderPipeline, synthetic_tokens

__all__ = ["GlobalOrderPipeline", "synthetic_tokens"]
