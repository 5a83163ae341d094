"""CLI: ``python -m repro_torch.obs --smoke [--device cpu]``.

Counterpart of ``python -m repro.obs``: run a short telemetry-on burst of
an elastic FIFO queue (on CUDA unless ``--device cpu``), print the live
metrics snapshot (JSON by default, Prometheus text with ``--format
prom``), and optionally export the host spans, the wave stages' detail
spans among them, as a Chrome/perfetto trace (``--trace PATH``).  Exit
status is 0 iff the burst ran, the drained wave summaries are
self-consistent (sequence numbers in order; each wave's valid ops are
its admitted puts, gets and ⊥ replies), and telemetry added no exchange
to a wave (the runtime's exchange count, on and off).
"""
from __future__ import annotations

import argparse
import sys


def _smoke(n_shards: int, waves: int, device) -> dict:
    """Telemetry-on waves on an elastic FIFO queue; returns the snapshot
    report {ok, exchanges, wave_summaries, prometheus, ...}."""
    import numpy as np
    import torch

    from ..dqueue import DeviceQueue, ElasticDeviceQueue
    from .export import to_prometheus
    from .trace import span, tracer

    q = ElasticDeviceQueue(n_shards, cap=256, payload_width=2,
                           ops_per_shard=8, metrics=True,
                           flight_k=max(16, waves), device=device)
    n = q.n_shards * q.L
    rng = np.random.default_rng(0)
    with span("obs:smoke", cat="cli", waves=waves):
        for _ in range(waves):
            is_enq = rng.random(n) < 0.6
            valid = rng.random(n) < 0.9
            payload = rng.integers(0, 1 << 20, (n, 2)).astype(np.int32)
            q.step(is_enq, valid, payload)
    rows = q.trajectory()
    ok = (len(rows) == waves
          and [r["seq"] for r in rows] == list(range(waves))
          and all(r["valid"] == r["puts"] + r["gets"] + r["bottom"]
                  for r in rows))
    # telemetry must not add exchanges: one wave with the ring on and off
    ex = {}
    zeros = (torch.zeros(n, dtype=torch.bool, device=q.device),) * 2
    pw = torch.zeros((n, 2), dtype=torch.int32, device=q.device)
    for tag, on in (("off", False), ("on", True)):
        dq = DeviceQueue(n_shards, cap=256, payload_width=2, ops_per_shard=8,
                         metrics=on, device=q.device)
        dq.step(dq.init_state(), *zeros, pw)
        ex[tag] = dq.runtime.n_exchanges
    snapshot = {
        "smoke": {"n_shards": q.n_shards, "waves": waves,
                  "queue_size": q.size, "device": str(q.device)},
        "exchanges": {"telemetry_off": ex["off"], "telemetry_on": ex["on"],
                      "added": ex["on"] - ex["off"]},
        "wave_summaries": rows,
        "spans": len(tracer.events()),
    }
    snapshot["ok"] = bool(ok and ex["on"] == ex["off"])
    snapshot["prometheus"] = to_prometheus(
        {k: v for k, v in snapshot.items() if k in ("smoke", "exchanges")},
        prefix="repro_obs")
    return snapshot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Wavescope: telemetry for the device wave path")
    ap.add_argument("--smoke", action="store_true",
                    help="run a telemetry-on burst and print the snapshot "
                         "(default)")
    ap.add_argument("--device", default=None,
                    help="device of the queue (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--shards", type=int, default=8,
                    help="queue shards (default 8)")
    ap.add_argument("--waves", type=int, default=6,
                    help="waves in the smoke burst (default 6)")
    ap.add_argument("--format", choices=("json", "prom"), default="json",
                    help="snapshot output format (default json)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the JSON snapshot to PATH")
    ap.add_argument("--trace", metavar="PATH",
                    help="record the wave stages' detail spans too and "
                         "export the host spans as a Chrome/perfetto "
                         "trace JSON to PATH")
    args = ap.parse_args(argv)

    if args.trace:        # the exported trace holds the waves' stages
        from .trace import tracer
        tracer.detail = True
    report = _smoke(args.shards, args.waves, args.device)

    from .export import to_json
    text = to_json(report)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    print(report["prometheus"] if args.format == "prom" else text)
    if args.trace:
        from .trace import tracer
        tracer.export_chrome_trace(args.trace)
        print(f"wrote {len(tracer.events())} spans to {args.trace}",
              file=sys.stderr)
    added = report["exchanges"]["added"]
    print(f"wavescope smoke: {len(report['wave_summaries'])} wave "
          f"summaries on {report['smoke']['device']}, +{added} exchanges "
          f"with telemetry on -> {'OK' if report['ok'] else 'FAIL'}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
