"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; the vision tower is a STUB (input_specs
provides precomputed patch embeddings, 2880 tokens = 5 anyres tiles x 576).
Source: hf:llava-hf/llava-v1.6 family."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, n_vision_tokens=2880,
)
