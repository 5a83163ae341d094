"""Continuous-batching serving over the Skueue request queue (FIFO mode).
Counterpart of ``repro/serve``."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
