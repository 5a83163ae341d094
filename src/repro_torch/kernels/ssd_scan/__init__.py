from .ops import ssd_scan
from .ref import ssd_chunk_parallel_ref, ssd_chunked_ref, ssd_scan_ref

__all__ = ["ssd_chunk_parallel_ref", "ssd_chunked_ref", "ssd_scan",
           "ssd_scan_ref"]
