from .scan_queue import (INF, QueueState, StackState, priority_queue_scan,
                         queue_compose, queue_op_transforms, queue_scan,
                         seap_bucket_lookup, seap_queue_scan, stack_compose,
                         stack_op_transforms, stack_scan,
                         strict_batch_deletemin)
from .seap import BOTTOM, INT32_MAX, INT32_MIN, check_seed_bounds

__all__ = ["BOTTOM", "INF", "INT32_MAX", "INT32_MIN", "QueueState",
           "StackState", "check_seed_bounds", "priority_queue_scan",
           "queue_compose", "queue_op_transforms", "queue_scan",
           "seap_bucket_lookup", "seap_queue_scan", "stack_compose",
           "stack_op_transforms", "stack_scan", "strict_batch_deletemin"]
