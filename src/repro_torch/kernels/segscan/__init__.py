from .ops import (make_tier_scan, priority_queue_scan_fused, queue_scan,
                  stack_scan, tiered_queue_scan)
from .ref import queue_scan_ref, stack_scan_ref, tiered_queue_scan_ref

__all__ = ["make_tier_scan", "priority_queue_scan_fused", "queue_scan",
           "queue_scan_ref", "stack_scan", "stack_scan_ref",
           "tiered_queue_scan", "tiered_queue_scan_ref"]
