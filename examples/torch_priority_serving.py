"""Priority-tiered serving on the port: SLA tiers through the device
priority queue.

Counterpart of ``examples/priority_serving.py``, section for section:

  §1 raw ``DevicePriorityQueue``: a batch flood then interactive arrivals —
     the wave serves tier 0 first, sequential consistency intact;
  §2 ``ServeEngine(priorities=2)``: mixed LM traffic, per-tier admission
     latency from ``tier_wait_stats()``;
  §3 ``relaxation=k``: the bounded tier-relaxation knob — dequeues take a
     locally-owned lower-tier head instead of a remote best-tier head, and
     the wave reports how many did (one relaxed-kernel launch a wave on
     CUDA).

Run:  PYTHONPATH=src python examples/torch_priority_serving.py
      [--device cpu] [--shards 4]
(default device ``cuda``; it raises where there is none.  The shards are
a ``LocalRuntime``'s, where the reference takes one per device.)
"""
import argparse

import numpy as np
import torch

from repro_torch.dqueue import DevicePriorityQueue
from repro_torch.runtime import LocalRuntime


def _on(rt, *xs):
    return tuple(torch.from_numpy(np.asarray(x)).to(rt.device) for x in xs)


def section_1_priority_wave(n_shards: int, device):
    print("== §1 priority wave: interactive ahead of a batch flood ==")
    rt = LocalRuntime(n_shards, device=device)
    # the wave must fit the 12-element flood on ANY shard count
    q = DevicePriorityQueue(n_shards, n_prios=2, cap=64, payload_width=1,
                            ops_per_shard=max(8, -(-12 // n_shards)),
                            runtime=rt)
    n = q.n_shards * q.L
    state = q.init_state()

    # wave 1: flood tier 1 (batch) with 12 elements
    e = np.zeros(n, bool)
    v = np.zeros(n, bool)
    pr = np.ones(n, np.int32)
    pw = np.zeros((n, 1), np.int32)
    e[:12] = v[:12] = True
    pw[:12, 0] = 1000 + np.arange(12)
    state, *_ = q.step(state, *_on(rt, e, v, pr, pw))

    # wave 2: 3 interactive arrivals + 6 dequeues in ONE fused wave
    e = np.zeros(n, bool)
    v = np.zeros(n, bool)
    pr = np.zeros(n, np.int32)
    pw = np.zeros((n, 1), np.int32)
    e[:3] = v[:3] = True
    pw[:3, 0] = 1 + np.arange(3)       # interactive ids 1..3
    v[3:9] = True                      # 6 dequeues
    state, tier, pos, m, dv, dok, ovf, _ = q.step(state,
                                                  *_on(rt, e, v, pr, pw))
    tier, dok, dv = (rt.to_host(x) for x in (tier, dok, dv))
    served = [(int(t), int(val[0])) for t, ok, val in
              zip(tier[3:9], dok[3:9], dv[3:9]) if ok]
    print(f"   6 dequeues served (tier, id): {served}")
    print(f"   -> the 3 same-wave interactive arrivals went first, then "
          f"batch FIFO order\n")
    return served


def section_2_engine_tiers(device):
    print("== §2 ServeEngine(priorities=2): per-tier admission latency ==")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("mamba2_130m").reduced(n_layers=1)
    model = build_model(cfg)
    rt = LocalRuntime(1, device=device)
    params = model.init_params(0, device=rt.device)
    eng = ServeEngine(model, params, max_slots=2, max_seq=16, priorities=2,
                      runtime=rt)
    batch = [Request(rid=i, prompt=[7, 8], max_new=2, prio=1)
             for i in range(8)]
    inter = [Request(rid=100 + i, prompt=[5, 6], max_new=2, prio=0)
             for i in range(3)]
    eng.submit(batch)      # batch flood staged first
    eng.submit(inter)      # interactive arrives after — still admitted first
    if not eng.run_until_drained(max_steps=400):
        raise SystemExit("the tier engine did not drain in 400 steps")
    stats = eng.tier_wait_stats()
    for p, st in sorted(stats.items()):
        name = "interactive" if p == 0 else "batch"
        print(f"   tier {p} ({name:11s}): n={st['n']} mean={st['mean']:.1f} "
              f"p50={st['p50']:.1f} p99={st['p99']:.1f} steps")
    print()
    return stats


def section_3_relaxation(n_shards: int, device):
    print("== §3 relaxation=k: locally-served lower-tier dequeues ==")
    rng = np.random.default_rng(0)
    counts = {}
    for k in (0, 1):
        rt = LocalRuntime(n_shards, device=device)
        q = DevicePriorityQueue(n_shards, n_prios=2, cap=64,
                                payload_width=1, ops_per_shard=8,
                                relaxation=k, runtime=rt)
        n = q.n_shards * q.L
        state = q.init_state()
        relaxed = 0
        for _ in range(8):
            e = rng.random(n) < 0.55
            v = rng.random(n) < 0.9
            pr = rng.integers(0, 2, n).astype(np.int32)
            pw = rng.integers(0, 1000, (n, 1)).astype(np.int32)
            state, *out = q.step(state, *_on(rt, e, v, pr, pw))
            relaxed += int(out[-1])
        counts[k] = relaxed
        print(f"   relaxation={k}: {relaxed} dequeues served from a "
              f"locally-owned lower-tier head")
    print("   (k=0 is strict priority order; k=1 trades bounded tier skew "
          "for locality)")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    section_1_priority_wave(args.shards, args.device)
    section_2_engine_tiers(args.device)
    section_3_relaxation(args.shards, args.device)


if __name__ == "__main__":
    main()
