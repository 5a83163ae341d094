from .ops import flash_attention
from .ref import attention_chunked, attention_ref

__all__ = ["attention_chunked", "attention_ref", "flash_attention"]
