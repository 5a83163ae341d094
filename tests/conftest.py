import os
import sys

# make tests/ helpers (multidev.py) importable under `PYTHONPATH=src pytest`
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Fail loudly on silent rank promotion everywhere in the suite.  Set via
# the environment BEFORE jax is imported so the multidev subprocess tests
# (which inherit os.environ) enforce it too.
os.environ.setdefault("JAX_NUMPY_RANK_PROMOTION", "raise")

import jax  # noqa: E402  (import after the env var is pinned)

jax.config.update("jax_numpy_rank_promotion", "raise")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself where "
        "torch.cuda.is_available() is false")
