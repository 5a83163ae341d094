#!/usr/bin/env python3
"""Check and time gloo's collectives between two processes on one CUDA card.

Run from the root of a checkout: ``python3 scripts/gloo_probe.py [--mb 50]``.
It starts two processes through ``repro_torch.runtime.launch_localhost``
(``torch.distributed`` with gloo over localhost, both on the card), checks
that ``all_to_all_single`` (even and uneven splits) and
``all_gather_into_tensor`` take CUDA tensors and return the right values,
then times an all-to-all of ``--mb`` MB a process on host tensors, CUDA
tensors and pinned host tensors, three calls each after a barrier (the
first call of each kind includes its connection set-up).  It prints the
card's name and power limit, then one JSON line a process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def child(mb: int) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['REPRO_RT_COORD']}",
        world_size=2, rank=int(os.environ["REPRO_RT_PID"]))
    rank, dev = dist.get_rank(), torch.device("cuda")
    out = {"rank": rank}
    x = torch.arange(8, dtype=torch.int32, device=dev) + 100 * rank
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    want = [0, 1, 2, 3, 100, 101, 102, 103] if rank == 0 else \
        [4, 5, 6, 7, 104, 105, 106, 107]
    out["all_to_all_even"] = y.tolist() == want
    ins, outs = ([3, 5], [3, 1]) if rank == 0 else ([1, 2], [5, 2])
    xi = torch.arange(sum(ins), dtype=torch.int32, device=dev) + 100 * rank
    yi = torch.empty(sum(outs), dtype=torch.int32, device=dev)
    dist.all_to_all_single(yi, xi, outs, ins)
    want = [0, 1, 2, 100] if rank == 0 else [3, 4, 5, 6, 7, 101, 102]
    out["all_to_all_uneven"] = yi.tolist() == want
    g = torch.empty(16, dtype=torch.int32, device=dev)
    dist.all_gather_into_tensor(g, x)
    out["all_gather_into_tensor"] = g.tolist() == (
        list(range(8)) + list(range(100, 108)))
    n = mb * (1 << 20) // 4
    for where in ("cpu", "cuda", "pinned"):
        if where == "pinned":
            xb = torch.ones(n, dtype=torch.int32).pin_memory()
            yb = torch.empty(n, dtype=torch.int32).pin_memory()
        else:
            xb = torch.ones(n, dtype=torch.int32, device=where)
            yb = torch.empty_like(xb)
        secs = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_to_all_single(yb, xb)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[f"all_to_all_{mb}MB_{where}_s"] = secs
    print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=50)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gloo_probe: no CUDA device")
    if args.child:
        child(args.mb)
        return 0
    from repro_torch.runtime import launch_localhost
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), torch.__version__, flush=True)
    for r in launch_localhost(script=__file__,
                              args=["--child", "--mb", str(args.mb)],
                              n_procs=2, timeout=300):
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
