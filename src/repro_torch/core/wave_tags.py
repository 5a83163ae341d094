"""The tags of the wave engine's request rows.

A request row is ``slot ‖ tag ‖ payload``: the wave engine packs it
(``dqueue/wave_engine.py``: ``_pack_request`` and its inactive fill row)
and the Stage-4 commit reads it (``kernels/ring_commit``, whose CUDA
source repeats the two active tags).  The reference defines them in
``repro/dqueue/wave_engine.py``; they live in a module of their own here
so that the commit's kernel package can read them without importing the
engine that imports it.
"""
TAG_INACTIVE = 0
TAG_PUT = 1
TAG_GET = 2
