"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155.  Source: hf:ibm-granite/granite-3.0 family."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab=49155,
)
