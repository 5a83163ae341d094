"""Skueue in PyTorch: the distributed queue, stack and priority queue on one
CUDA device, and the LM serving path that rides the queue.

The PyTorch port of the ``repro`` JAX package.  It keeps the reference's
module layout and names, so each module here has its counterpart under
``repro/``.  The shard axis of the reference's device mesh becomes the
leading dimension of every state and wave tensor on one device, and the
reference's collectives go through one exchange seam
(:meth:`repro_torch.runtime.LocalRuntime.exchange`).

Entry points default to ``device="cuda"`` and raise where there is no
CUDA device; pass ``device="cpu"`` to run the kernels' plain versions.
This package imports torch and numpy only, never jax.
"""
