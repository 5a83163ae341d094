"""Serving launcher: continuous batching fed by the Skueue request queue.

  python -m repro_torch.launch.serve --arch zamba2_1p2b --requests 12

Counterpart of ``repro/launch/serve.py``.  Serves the reduced config of
``--arch`` with random parameters (seed 0) over a one-shard queue, on
``--device`` (default ``cuda``; it raises where there is none), and
prints what was served, the tokens/s and whether admission kept FIFO
order.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init_params(0, device=args.device)
    eng = ServeEngine(model, params, 1, max_slots=args.slots, max_seq=32,
                      device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in
                                   rng.integers(0, cfg.vocab, 4)],
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    eng.submit(reqs[: len(reqs) // 2])
    for _ in range(3):
        eng.step()
    eng.submit(reqs[len(reqs) // 2:])
    ok = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"served {eng.stats['served']}/{len(reqs)} requests, {tok} tokens "
          f"in {dt:.1f}s ({tok / dt:.1f} tok/s on {eng.device}); "
          f"drained={ok}")
    order = sorted(reqs, key=lambda r: r.start_step)
    fifo = all(order[i].enqueue_step <= order[i + 1].enqueue_step
               for i in range(len(order) - 1))
    print(f"queue FIFO admission order preserved: {fifo}")
    for r in reqs[:3]:
        print(f"  rid={r.rid} prompt={r.prompt} -> out={r.out}")


if __name__ == "__main__":
    main()
