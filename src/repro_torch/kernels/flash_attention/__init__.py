from .ops import FlashAttention, flash_attention
from .ref import attention_backward_chunked, attention_chunked, attention_ref

__all__ = ["FlashAttention", "attention_backward_chunked",
           "attention_chunked", "attention_ref", "flash_attention"]
