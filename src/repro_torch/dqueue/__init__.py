"""SKUEUE device path in PyTorch: the FIFO wave over one device's shards.

:class:`WaveEngine` drives :class:`FifoDiscipline` at two exchanges per
wave (one per wave in pipelined bursts); :class:`ElasticDeviceQueue` adds
runtime JOIN/LEAVE membership, :class:`QueueOverflowError` on capacity
violation, and the pressure API.
"""
from .device_queue import DeviceQueue, DeviceQueueState, FifoDiscipline
from .elastic import ElasticDeviceQueue
from .errors import QueueOverflowError, ServeInvariantError
from .wave_engine import Discipline, WaveEngine, post_enqueue_peak_overflow

__all__ = ["DeviceQueue", "DeviceQueueState", "Discipline",
           "ElasticDeviceQueue", "FifoDiscipline", "QueueOverflowError",
           "ServeInvariantError", "WaveEngine", "post_enqueue_peak_overflow"]
