"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865 — encoder-decoder; conv frontend is a STUB (input_specs provides
precomputed frame embeddings).  Source: Whisper [arXiv:2212.04356]."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, enc_layers=12, enc_seq=1500,
)
