"""Wavescope observability on the port: watch the queue without slowing it.

Counterpart of ``examples/observability.py``, section for section:

1. device metrics — every wave leaves one summary row in a device-side
   ring (no extra exchange); drained at burst ends,
2. host tracing — the span API + Chrome-trace/perfetto export,
3. flight recorder — an overflow arrives with the occupancy trajectory
   that led to it,
4. exposition — ServeEngine.metrics() -> JSON / Prometheus text.

Run:  PYTHONPATH=src python examples/torch_observability.py
      [--device cpu] [--shards 4] [--trace PATH]
(default device ``cuda``; it raises where there is none; the trace goes
to the temporary directory unless ``--trace`` names a path.)
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.obs import span, timers, to_prometheus, tracer
from repro_torch.runtime import LocalRuntime


def section_device_metrics(n_shards: int, device):
    """§1 every wave records one metrics row, free of exchanges."""
    from repro_torch.dqueue import ElasticDeviceQueue

    rt = LocalRuntime(n_shards, device=device)
    q = ElasticDeviceQueue(n_shards, cap=256, payload_width=2,
                           ops_per_shard=8, metrics=True, runtime=rt)
    n = q.n_shards * 8
    rng = np.random.default_rng(0)
    K = 6
    is_enq = rng.random((K, n)) < 0.7
    valid = rng.random((K, n)) < 0.8
    payload = rng.integers(0, 99, (K, n, 2)).astype(np.int32)
    x0 = rt.n_exchanges
    with timers("burst"):
        q.run_waves(is_enq, valid, payload)
    rows = q.trajectory()   # drained into the flight recorder at burst end
    print(f"[device]   {len(rows)} wave rows drained after one "
          f"{timers('burst').elapsed('last') * 1e3:.1f} ms burst "
          f"({rt.n_exchanges - x0} exchanges for {K} waves):")
    for r in rows[:3]:
        print(f"           wave {r['seq']}: +{r['puts']} puts "
              f"-{r['gets']} gets  occ={r['occ']}  "
              f"headroom={r['headroom']}")
    return rows


def section_tracing(path):
    """§2 spans nest, name torch.profiler ranges, and export a perfetto
    trace."""
    with span("example:outer", cat="demo", note=1):
        with span("example:inner", cat="demo"):
            pass
    path = tracer.export_chrome_trace(path)
    names = [e["name"] for e in tracer.events()]
    print(f"[trace]    {len(names)} spans recorded "
          f"(incl. {[n for n in names if n.endswith('burst')][:1]}); "
          f"open {path} in ui.perfetto.dev")
    return names


def section_flight_recorder(device):
    """§3 an overflow carries the occupancy ramp that caused it."""
    from repro_torch.dqueue import ElasticDeviceQueue, QueueOverflowError

    q = ElasticDeviceQueue(1, cap=8, payload_width=1, ops_per_shard=4,
                           metrics=True, runtime=LocalRuntime(1, device))
    e = np.array([True, True, True, False])       # net +2 per wave
    v = np.array([True, True, True, True])
    pw = np.ones((4, 1), np.int32)
    try:
        for _ in range(8):
            q.step(e, v, pw)
    except QueueOverflowError as err:
        ramp = [r["occ"][0] for r in err.trajectory]
        print(f"[recorder] overflow at cap=8; flight recorder replays the "
              f"occupancy ramp {ramp}")
        return ramp
    raise SystemExit("the cap-8 queue did not overflow")


def section_serve_metrics(device):
    """§4 ServeEngine.metrics() -> Prometheus text exposition."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("mamba2_130m").reduced(n_layers=1)
    model = build_model(cfg)
    rt = LocalRuntime(1, device=device)
    params = model.init_params(0, device=rt.device)
    eng = ServeEngine(model, params, max_slots=2, max_seq=16,
                      telemetry=True, runtime=rt)
    rng = np.random.default_rng(0)
    eng.submit([Request(rid=i, prompt=[int(t) for t in
                                       rng.integers(0, cfg.vocab, 2)],
                        max_new=2) for i in range(3)])
    eng.run_until_drained(max_steps=100)
    snap = eng.metrics()
    prom = to_prometheus(snap)
    print(f"[serve]    served={snap['served']} over {len(snap['waves'])} "
          "queue waves; Prometheus exposition (excerpt):")
    for line in prom.splitlines():
        if line.startswith(("repro_served", "repro_queue_depth",
                            "repro_queue_occupancy")):
            print(f"           {line}")
    return snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "wavescope_trace.json"))
    args = ap.parse_args(argv)
    section_device_metrics(args.shards, args.device)
    section_tracing(args.trace)
    section_flight_recorder(args.device)
    section_serve_metrics(args.device)


if __name__ == "__main__":
    main()
