"""Cap torch's intra-op threads in each pytest-xdist worker.

With ``-n N`` every worker process starts torch's default pool of one
thread per core, so N workers run N times as many threads as there are
cores and the port's CPU tests (eager torch, many small ops) slow down
by an order of magnitude.  Each worker collects every test file before it
runs any test, so setting the cap when this module is imported gives
each worker ``cpu_count // N`` threads for all the port's tests.  A plain
``pytest`` run (no xdist) keeps every core.  The cap lives here only: the
package and ``chip_smoke.py`` set no thread count.
"""
import os

import torch


def thread_cap() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(thread_cap())


def test_intra_op_threads_are_capped_per_worker():
    assert torch.get_num_threads() == thread_cap()
