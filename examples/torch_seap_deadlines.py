"""Arbitrary priorities and deadline scheduling on the port: the Seap
discipline.

Counterpart of ``examples/seap_deadlines.py``, section for section:

  §1 raw ``DeviceSeapQueue``: int32 keys, served smallest-key-first at
     bucket granularity;
  §2 the bucket directory as a *rolling window*: deadline-like monotone
     keys — drained past buckets merge away while the future range
     splits, so the refinement follows the live keys;
  §3 ``ServeEngine(deadline=True)``: earliest-deadline-first LM admission
     with miss-rate reporting from ``deadline_stats()``.

Run:  PYTHONPATH=src python examples/torch_seap_deadlines.py
      [--device cpu] [--shards 4]
(default device ``cuda``; it raises where there is none.  The shards are
a ``LocalRuntime``'s, where the reference takes one per device.)
"""
import argparse

import numpy as np
import torch

from repro_torch.dqueue import DeviceSeapQueue
from repro_torch.runtime import LocalRuntime


def _on(rt, *xs):
    return tuple(torch.from_numpy(np.asarray(x)).to(rt.device) for x in xs)


def section_1_arbitrary_keys(n_shards: int, device):
    print("== §1 arbitrary keys: smallest key served first ==")
    rt = LocalRuntime(n_shards, device=device)
    # directory seeded at 0 and 256: keys < 0 / [0, 256) / >= 256
    q = DeviceSeapQueue(n_shards, n_buckets=4, cap=64, payload_width=1,
                        ops_per_shard=max(8, -(-12 // n_shards)),
                        seed_bounds=[0, 256], runtime=rt)
    n = q.n_shards * q.L
    state = q.init_state()

    # wave 1: enqueue 12 elements with scattered keys
    keys = np.array([700, -3, 250, 9, 512, -88, 31, 400, 5, 123, 777, -1])
    e = np.zeros(n, bool)
    v = np.zeros(n, bool)
    ky = np.zeros(n, np.int32)
    pw = np.zeros((n, 1), np.int32)
    e[:12] = v[:12] = True
    ky[:12] = keys
    pw[:12, 0] = keys          # payload = key, to see the serve order
    state, *_ = q.step(state, *_on(rt, e, v, ky, pw))
    print(f"  enqueued keys (arrival order): {keys.tolist()}")

    # wave 2: 12 dequeues drain the directory in boundary order
    e = np.zeros(n, bool)
    v = np.zeros(n, bool)
    v[:12] = True
    state, _, _, _, dv, dok, _, _ = q.step(state, *_on(rt, e, v, ky, pw))
    dv, dok = rt.to_host(dv), rt.to_host(dok)
    served = [int(dv[i, 0]) for i in range(n) if dok[i]]
    print(f"  served order:                  {served}")
    print("  (buckets [<0 | 0..255 | >=256] in key order; FIFO inside a "
          "bucket)")
    return served


def section_2_rolling_window(n_shards: int, device):
    print("== §2 deadline-like keys: the directory rolls forward ==")
    rt = LocalRuntime(n_shards, device=device)
    q = DeviceSeapQueue(n_shards, n_buckets=4, cap=64, payload_width=1,
                        ops_per_shard=max(16, -(-16 // n_shards)),
                        split_occupancy=6, seed_bounds=[8, 16, 24],
                        runtime=rt)
    n = q.n_shards * q.L
    state = q.init_state()
    t = 0
    rolls = []
    for epoch in range(6):
        # keys advance with time: enqueue 8 near-future deadlines, serve 6
        e = np.zeros(n, bool)
        v = np.zeros(n, bool)
        ky = np.zeros(n, np.int32)
        pw = np.zeros((n, 1), np.int32)
        e[:8] = v[:8] = True
        ky[:8] = t + np.array([2, 3, 5, 7, 9, 12, 16, 20])
        v[8:14] = True
        state, *_ = q.step(state, *_on(rt, e, v, ky, pw))
        lo, act = rt.to_host(state.lo), rt.to_host(state.active)
        bounds = sorted(int(b) for b, a in zip(lo, act) if a
                        and int(b) > -(2 ** 31))
        rolls.append(bounds)
        print(f"  t={t:3d}: boundaries above the root: {bounds}")
        t += 8
    print("  (splits of the loaded future range recycle the ids of "
          "drained past buckets)")
    return rolls


def section_3_edf_serving(device):
    print("== §3 ServeEngine(deadline=True): EDF admission ==")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("mamba2_130m").reduced(n_layers=1)
    model = build_model(cfg)
    rt = LocalRuntime(1, device=device)
    params = model.init_params(0, device=rt.device)
    eng = ServeEngine(model, params, max_slots=2, max_seq=16, deadline=True,
                      runtime=rt)
    batch = [Request(rid=i, prompt=[1, 2], max_new=2) for i in range(6)]
    urgent = [Request(rid=100 + i, prompt=[3, 4], max_new=2)
              for i in range(3)]
    eng.submit(batch, deadline=50)    # generous deadlines, staged first
    eng.submit(urgent, deadline=4)    # tight deadlines, arrive later
    eng.run_until_drained(max_steps=200)
    print(f"  urgent start steps: {[r.start_step for r in urgent]}")
    print(f"  batch  start steps: {[r.start_step for r in batch]}")
    print(f"  deadline_stats: {eng.deadline_stats()}")
    return eng.deadline_stats()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    section_1_arbitrary_keys(args.shards, args.device)
    section_2_rolling_window(args.shards, args.device)
    section_3_edf_serving(args.device)


if __name__ == "__main__":
    main()
