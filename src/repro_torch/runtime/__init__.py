"""The runtime seam between the wave stack and the device (counterpart
of ``repro/runtime``): one process over one device (:class:`LocalRuntime`),
the same with a modelled wire and scheduled failures (:class:`SimRuntime`),
and shards split over processes (:class:`DistributedRuntime`, started by
:func:`launch_localhost`)."""
from .base import ProcessRole, Runtime, VirtualShard, select_devices
from .distributed import DistributedRuntime
from .launcher import ProcResult, find_free_port, launch_localhost
from .local import LocalRuntime
from .sim import LatencyModel, SimRuntime

__all__ = ["DistributedRuntime", "LatencyModel", "LocalRuntime",
           "ProcResult", "ProcessRole", "Runtime", "SimRuntime",
           "VirtualShard", "find_free_port", "launch_localhost",
           "select_devices"]
