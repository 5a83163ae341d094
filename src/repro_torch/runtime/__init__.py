"""The runtime seam between the wave stack and the device (counterpart
of ``repro/runtime``).  Only the single-device local runtime exists."""
from .base import Runtime, VirtualShard
from .local import LocalRuntime

__all__ = ["LocalRuntime", "Runtime", "VirtualShard"]
