from .scan_queue import (INF, QueueState, queue_compose, queue_op_transforms,
                         queue_scan)

__all__ = ["INF", "QueueState", "queue_compose", "queue_op_transforms",
           "queue_scan"]
