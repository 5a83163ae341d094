"""Elastic scaling in the PyTorch port, two layers of the system:

1. the PAPER's JOIN/LEAVE: processes enter/leave the running queue overlay
   mid-traffic (update phases, anchor handoff, DHT data movement), with
   sequential consistency preserved throughout (host bookkeeping);
2. the DEVICE path's JOIN/LEAVE: an ``ElasticDeviceQueue`` grows and
   shrinks its shard set mid-traffic — one migration exchange per
   membership change, FIFO order and every in-flight element preserved.

Run:  PYTHONPATH=src python examples/torch_elastic_scaling.py [--device cpu]
(default device ``cuda``; it raises where there is none).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.consistency import check_sequential_consistency
from repro_torch.core.protocol import DEQ, ENQ, Skueue
from repro_torch.dqueue import ElasticDeviceQueue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    # --- 1. protocol-level churn -------------------------------------------
    sk = Skueue(6, mode="queue", seed=1)
    rng = np.random.default_rng(2)

    def inject(s, rnd):
        nids = s.ring.node_ids()
        if rnd % 2 == 0 and rnd <= 120:
            s.inject(nids[int(rng.integers(len(nids)))],
                     ENQ if rng.random() < 0.6 else DEQ)
        if rnd == 10:
            print("  round 10: process 6 JOINs")
            s.request_join()
        if rnd == 30:
            print("  round 30: process 7 JOINs")
            s.request_join()
        if rnd == 50:
            print("  round 50: process 2 LEAVEs")
            s.request_leave(2)

    sk.run_rounds(220, inject_fn=inject)
    stats = check_sequential_consistency(sk)
    sk.check_dht_placement()
    procs = sorted(set(sk.ring.proc[n] for n in sk.ring.node_ids()))
    print(f"[protocol] consistent through churn: {stats['n_requests']} reqs, "
          f"{sk.update_phases} update phases, processes now {procs}")

    # --- 2. device-path live resharding -------------------------------------
    eq = ElasticDeviceQueue(2, cap=64, payload_width=2, ops_per_shard=8,
                            pool_size=4, device=dev)
    sent, got = 0, []

    def traffic(n_enq, n_deq):
        """One wave at the queue's CURRENT width (it changes under us)."""
        nonlocal sent
        n = eq.n_shards * eq.L
        e = np.zeros(n, bool)
        v = np.zeros(n, bool)
        pw = np.zeros((n, 2), np.int32)
        n_enq, n_deq = min(n_enq, n), min(n_deq, n - n_enq)
        e[:n_enq] = v[:n_enq] = True
        pw[:n_enq, 0] = np.arange(sent, sent + n_enq)
        v[n_enq:n_enq + n_deq] = True
        sent += n_enq
        _, _, dv, dok, _ = eq.step(*(torch.from_numpy(x).to(dev)
                                     for x in (e, v, pw)))
        dv, dok = dv.cpu().numpy(), dok.cpu().numpy()
        got.extend(int(dv[i, 0]) for i in range(n) if dok[i])

    traffic(16, 0)                      # load up on 2 shards
    traffic(16, 4)
    s = eq.grow(2)                      # JOIN: 2 -> 4 shards, live
    print(f"[device]   grow  {s['P_from']}->{s['P_to']} on {dev}: moved "
          f"{s['moved']} elems in {s['collectives']} exchange(s), "
          f"{s['wave_s'] * 1e3:.1f} ms wave")
    traffic(16, 8)                      # keep the traffic flowing
    s = eq.shrink([1])                  # LEAVE of shard 1: 4 -> 3 shards
    print(f"[device]   LEAVE {s['P_from']}->{s['P_to']} on {dev}: moved "
          f"{s['moved']} elems in {s['collectives']} exchange(s), "
          f"{s['wave_s'] * 1e3:.1f} ms wave")
    while len(got) < sent:              # drain on the resized shard set
        traffic(0, eq.n_shards * eq.L)
    assert got == list(range(sent)), "FIFO broken by resharding!"
    print(f"[device]   {sent} elements dequeued in exact FIFO order through "
          f"grow+LEAVE; final shard set {eq.n_shards} shards")


if __name__ == "__main__":
    main()
