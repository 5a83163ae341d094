#!/usr/bin/env python3
"""Time the paper's protocol on the host: the port's ``Skueue`` against
the reference's on the same schedule and the same CPU.

Run from the root of a checkout: ``python3 scripts/protocol_host_time.py
[--n 1024] [--rounds 120]``.  Both packages run ``chip_smoke.py``'s
``path:protocol_replay`` schedule (``protocol_run``: Fig. 4's ``--full``
setting, 1.0 requests per virtual node per round, 16 processes joining
at rounds 30 and 60, 16 leaving at 90, the anchor's among them, run to
quiescence and checked), in queue and stack mode, in turns: reference,
port, port, reference.  Each run prints one JSON line: the host seconds
to quiescence and of the consistency check, requests, messages, update
phases, and whether its records equal the reference's first run's.  The
protocol is host code on both sides (numpy, ``heapq``, dicts): no device
is used.  It imports the JAX package's ``repro.core`` modules, which
import no jax.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_024)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro.core.consistency import check_sequential_consistency
    from repro.core.protocol import Skueue
    ref_impl = (Skueue, check_sequential_consistency)
    for mode in ("queue", "stack"):
        want = None
        for who in ("reference", "port", "port", "reference"):
            sk, rec = smoke.protocol_run(
                mode, args.seed, n=args.n, rounds=args.rounds,
                impl=ref_impl if who == "reference" else None)
            records = [tuple(vars(r).values()) for r in sk.requests]
            want = records if want is None else want
            print(json.dumps({
                "mode": mode, "impl": who, "n": args.n,
                "rounds": args.rounds, "host_sim_s": rec["host_sim_s"],
                "host_check_s": rec["host_check_s"],
                "requests": rec["requests"],
                "global_requests": rec["global_requests"],
                "total_msgs": rec["total_msgs"],
                "update_phases": rec["update_phases"],
                "records_equal_reference": records == want}), flush=True)


if __name__ == "__main__":
    main()
