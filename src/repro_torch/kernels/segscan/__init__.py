from .ops import queue_scan
from .ref import queue_scan_ref

__all__ = ["queue_scan", "queue_scan_ref"]
