"""SKUEUE device path in PyTorch: queue, stack, priority tiers and Seap's
arbitrary keys over shards on one device, or split over the processes of
a :class:`~repro_torch.runtime.DistributedRuntime`.

:class:`WaveEngine` drives a discipline (:class:`FifoDiscipline`,
:class:`LifoDiscipline`, :class:`PriorityDiscipline`,
:class:`SeapDiscipline`) at two exchanges per
wave (one per wave in pipelined bursts); the elastic wrappers add runtime
JOIN/LEAVE membership, :class:`QueueOverflowError` on capacity violation,
and the pressure API.  :class:`WorkQueue` is the paper's lease-based work
stealing over a :class:`DeviceQueue`.
"""
from .device_queue import (DeviceQueue, DeviceQueueState, DeviceStack,
                           DeviceStackState, FifoDiscipline, LifoDiscipline)
from .elastic import ElasticDeviceQueue, ElasticDeviceStack
from .errors import QueueOverflowError, ServeInvariantError
from .priority_queue import (DevicePriorityQueue, ElasticDevicePriorityQueue,
                             PriorityDiscipline, PriorityQueueState)
from .seap_queue import (DeviceSeapQueue, ElasticDeviceSeapQueue,
                         SeapDiscipline, SeapQueueState,
                         default_split_occupancy)
from .wave_engine import Discipline, WaveEngine, post_enqueue_peak_overflow
from .work_queue import WorkQueue

__all__ = ["DevicePriorityQueue", "DeviceQueue", "DeviceQueueState",
           "DeviceSeapQueue", "DeviceStack", "DeviceStackState",
           "Discipline", "ElasticDevicePriorityQueue", "ElasticDeviceQueue",
           "ElasticDeviceSeapQueue", "ElasticDeviceStack", "FifoDiscipline",
           "LifoDiscipline", "PriorityDiscipline", "PriorityQueueState",
           "QueueOverflowError", "SeapDiscipline", "SeapQueueState",
           "ServeInvariantError", "WaveEngine", "WorkQueue",
           "default_split_occupancy", "post_enqueue_peak_overflow"]
