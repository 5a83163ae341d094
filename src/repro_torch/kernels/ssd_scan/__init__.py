from .ops import SSDScan, ssd_scan
from .ref import (ssd_backward_chunk_parallel_ref, ssd_chunk_parallel_ref,
                  ssd_chunked_ref, ssd_scan_backward_ref, ssd_scan_ref)

__all__ = ["SSDScan", "ssd_backward_chunk_parallel_ref",
           "ssd_chunk_parallel_ref", "ssd_chunked_ref",
           "ssd_scan", "ssd_scan_backward_ref", "ssd_scan_ref"]
