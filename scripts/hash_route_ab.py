#!/usr/bin/env python3
"""Time the port's hash route on one card, for one or more source trees.

Run from the root of a checkout: ``python3 scripts/hash_route_ab.py
[--tree DIR ...] [--rounds 2]``.  Each tree is the root of a checkout of
the port (default: this one); give an older commit unpacked with ``git
archive`` to compare it with this one on the same card.  The trees run in
turns, forwards then backwards (A, B, B, A with two), each in a process of
its own that builds the tree's ``csrc/hash_route.cu`` into that tree's
build directory.  At n = 1, 1,024, 39,102 (the live set ``hash_balance``
migrates at seed 0), 65,536 (the largest a path migrates) and 2^24, at 64
shards, one call is checked twice in a row against the tree's plain
version, then timed: wrapper ms (CUDA events, the mean of 100 calls) and
device ms and kernels a call (``chip_smoke.py``'s profiler helper).  Each
run prints one JSON line per n, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1, 1_024, 39_102, 65_536, 1 << 24)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(tree: str, rnd: int) -> None:
    """Time the hash route of ``tree`` (its src/ comes first on the path)."""
    import numpy as np
    import torch
    from repro_torch.kernels.hash_route import hash_route, hash_route_ref
    smoke = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_max = max(SIZES)
    pos_all = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n_max,
                                            dtype=np.int64).astype(np.int32))
    valid_all = torch.from_numpy(rng.random(n_max) < 0.9)
    for n in SIZES:
        pos, valid = pos_all[:n].to(dev), valid_all[:n].to(dev)
        want = hash_route_ref(pos, valid, 64)
        same = True
        for _ in range(2):
            got = hash_route(pos, valid, 64)
            torch.cuda.synchronize()
            same &= all(torch.equal(a, b) for a, b in zip(got, want))
        ms = smoke.time_ms(lambda: hash_route(pos, valid, 64), 100, torch)
        calls = smoke._kernel_calls(torch, lambda: hash_route(pos, valid, 64),
                                    reps=20)
        print(json.dumps({
            "tree": tree, "round": rnd, "n": n, "n_shards": 64,
            "identical": same, "wrapper_ms": ms,
            "device_ms": sum(d for _, d in calls.values()) if calls
            else "not measured",
            "kernels_per_call": {k: c for k, (c, _) in calls.items()}}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="root of a checkout of the port (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--round", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        sys.path.insert(0, str(Path(args.child) / "src"))
        child(args.child, args.round)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = [str(Path(t).resolve()) for t in (args.tree or [ROOT])]
    rc = 0
    for rnd in range(args.rounds):
        for tree in trees if rnd % 2 == 0 else trees[::-1]:
            env = {**os.environ, "PYTHONPATH": str(Path(tree) / "src")}
            rc |= subprocess.run([sys.executable, __file__, "--child", tree,
                                  "--round", str(rnd)], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
