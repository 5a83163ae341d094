"""Hand-written CUDA kernels for Hopper, each beside its plain version.

One package per kernel of the reference's ``repro/kernels``, and
``relaxed`` and ``ring_commit`` where the reference runs plain JAX:
``ops.py`` is the public wrapper (kernel on CUDA tensors, plain version
on CPU tensors, a launch count), ``ref.py`` the plain PyTorch version,
``kernel.py`` the ``ctypes`` launcher of ``csrc/<name>.cu``.
"""
from .backend import build, resolve_device

__all__ = ["build", "resolve_device"]
