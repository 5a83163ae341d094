"""Continuous-batching serving over the Skueue request queue: FIFO, SLA
tiers and EDF admission, admission policies and autoscaling.  Counterpart
of ``repro/serve``."""
from ..dqueue import QueueOverflowError, ServeInvariantError
from .admission import (AdmissionPolicy, AdmissionRejected, DeferPolicy,
                        DegradePolicy, PressureSignal, ShedPolicy,
                        resolve_policy)
from .controller import ControllerConfig, HysteresisController
from .engine import Request, ServeEngine

__all__ = ["AdmissionPolicy", "AdmissionRejected", "ControllerConfig",
           "DeferPolicy", "DegradePolicy", "HysteresisController",
           "PressureSignal", "QueueOverflowError", "Request",
           "ServeEngine", "ShedPolicy", "ServeInvariantError",
           "resolve_policy"]
