"""Public wrapper of flash attention: kernel on CUDA, plain on CPU.

Counterpart of ``repro/kernels/flash_attention/ops.py:flash_attention``.
The GQA fold and its per-group launches are gone: the kernel reads kv
head ``h // (Hq // Hkv)`` itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import attention_chunked


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; Hq % Hkv == 0 (GQA).

    Returns [B, Hq, Lq, D] in q's dtype.  Queries align to the end of the
    keys; any Lq <= Lk is taken (no block multiple).  A CUDA tensor goes
    to a CUDA kernel, which raises if it cannot be built or launched; a
    CPU tensor goes to the plain version.  ``flash_attention.launches``
    counts launches of either CUDA kernel, ``flash_attention.tc_launches``
    those of the tensor-core one, as the launcher reports them.
    """
    if q.device.type != "cuda":
        return attention_chunked(q, k, v, causal=causal, window=window)
    from .kernel import flash_attention_kernel
    out, tensor_cores = flash_attention_kernel(q, k, v, causal=causal,
                                               window=window)
    flash_attention.launches += 1
    flash_attention.tc_launches += tensor_cores
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
