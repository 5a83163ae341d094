from .recorder import FlightRecorder
from .trace import span

__all__ = ["FlightRecorder", "span"]
