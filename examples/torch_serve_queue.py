"""End-to-end serving on the port: a small LM served with batched
requests that flow through the SKUEUE distributed request queue
(continuous batching).

Counterpart of ``examples/serve_queue.py``: the paper's use case as a
serving feature, cross-host FIFO admission as the queue's sequential
consistency.  It runs ``repro_torch.launch.serve`` (the reduced config
of ``--arch``, random weights from seed 0), by default llama3-8b's with
10 requests on ``cuda``; other arguments pass through.

Run:  PYTHONPATH=src python examples/torch_serve_queue.py [--device cpu]
      [--arch llama3_8b] [--requests 10]
"""
import sys

from repro_torch.launch.serve import main


if __name__ == "__main__":
    main(["--arch", "llama3_8b", "--requests", "10"] + sys.argv[1:])
