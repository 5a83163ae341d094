from .scan_queue import (INF, QueueState, StackState, priority_queue_scan,
                         queue_compose, queue_op_transforms, queue_scan,
                         stack_compose, stack_op_transforms, stack_scan,
                         strict_batch_deletemin)

__all__ = ["INF", "QueueState", "StackState", "priority_queue_scan",
           "queue_compose", "queue_op_transforms", "queue_scan",
           "stack_compose", "stack_op_transforms", "stack_scan",
           "strict_batch_deletemin"]
