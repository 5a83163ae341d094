#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel bit for bit against its plain PyTorch version and times
both, then drives the elastic FIFO queue through its entry points at full
size (64 shards x 65,536 slots x 4 int32 words, 65,536-op waves, a
backlog above 1,000,000 elements, LEAVE of 16 shards and JOIN back), and
checks FIFO order, ⊥ counts, overflow, migration counts, the exchange
budget and the kernels' launch counts.  One JSON line per phase; the line
before the last lists the kernels, the last line is the result.  Any
failed check raises, and the exit code is then not 0.  Without a CUDA
device, or outside a checkout, it fails before printing anything.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MEM_BPS = 3.35e12      # H100 SXM device memory rate, bytes/s
# H100 SXM INT32 rate outside the tensor cores, operations/s: 64 INT32
# lanes per SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper) x 132
# SMs x 1.98 GHz boost (the clock behind the data sheet's 67 TFLOP/s FP32)
INT_OPS = 64 * 132 * 1.98e9
SCAN_OPS = 20          # int ops per op: transform, ~2 composes, emission
HASH_OPS = 12          # int ops per element: splitmix32, shift, modulo
CARD = ""              # "name, power limit" from nvidia-smi, set in main()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def time_ms(fn, reps: int, torch) -> float:
    """Mean device milliseconds per call, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_b, t_o = n_bytes / MEM_BPS * 1e3, n_ops / INT_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


# ----------------------------------------------------------------- phases --
def phase_build():
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    info = backend.build()
    total = time.perf_counter() - t0
    kernels = {}
    for name, rec in info.items():
        fns, cur = [], None
        for line in rec["ptxas"].splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                cur = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                fns.append({"function": cur, "registers": int(m.group(1)),
                            "smem_bytes": int(smem.group(1)) if smem else 0})
        kernels[name] = {"seconds": rec["seconds"], "cached": rec["cached"],
                         "functions": fns}
    for name in info:
        backend.load(name)
    emit("build", seconds=total, kernels=kernels)


def phase_queue_scan(torch, rng, results):
    from repro_torch.kernels.segscan import queue_scan, queue_scan_ref
    dev = torch.device("cuda")
    mixes = {"enq65": (0.65, 1.0), "deq_only": (0.0, 1.0),
             "valid80": (0.5, 0.8)}
    states = [(0, -1), (1_000_000, 1_005_000)]
    for n in (65_536, 16_777_216):
        worst, launches0 = 0, queue_scan.launches
        for mix, (p_enq, p_valid) in mixes.items():
            e = torch.from_numpy(rng.random(n) < p_enq).to(dev)
            v = torch.from_numpy(rng.random(n) < p_valid).to(dev)
            for f, l in states:
                f_t = torch.tensor(f, dtype=torch.int32, device=dev)
                l_t = torch.tensor(l, dtype=torch.int32, device=dev)
                got = queue_scan(e, v, f_t, l_t)
                want = queue_scan_ref(e, v, f_t, l_t)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                check(same, f"queue_scan n={n} {mix} state={(f, l)} "
                            f"bit-identical to its plain version")
                worst = max(worst, max_abs_err(got, want))
        # time the main-path mix from the empty queue
        e = torch.from_numpy(rng.random(n) < 0.65).to(dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        f_t = torch.tensor(0, dtype=torch.int32, device=dev)
        l_t = torch.tensor(-1, dtype=torch.int32, device=dev)
        ms = time_ms(lambda: queue_scan(e, v, f_t, l_t), 100, torch)
        plain = time_ms(lambda: queue_scan_ref(e, v, f_t, l_t), 20, torch)
        b_ms, b_by = bound(7 * n + 16, SCAN_OPS * n)
        rec = {"n": n, "mixes": list(mixes), "states": states,
               "bit_identical": True, "max_abs_err": worst,
               "launches": queue_scan.launches - launches0, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        results[("queue_scan", n)] = rec
        emit("kernel:queue_scan", **rec)


def phase_hash_route(torch, rng, results):
    from repro_torch.kernels.hash_route import hash_route, hash_route_ref
    dev = torch.device("cuda")
    n = 16_777_216
    base = int(rng.integers(-2 ** 31, 2 ** 31))
    pos = torch.from_numpy(((base + np.arange(n, dtype=np.int64) + 2 ** 31)
                            % 2 ** 32 - 2 ** 31).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for n_shards in (48, 64):
        launches0 = hash_route.launches
        got = hash_route(pos, valid, n_shards)
        want = hash_route_ref(pos, valid, n_shards)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, want))
        check(identical,
              f"hash_route n={n} n_shards={n_shards} identical to plain")
        ms = time_ms(lambda: hash_route(pos, valid, n_shards), 100, torch)
        plain = time_ms(lambda: hash_route_ref(pos, valid, n_shards), 20,
                        torch)
        b_ms, b_by = bound(9 * n + 4 * n_shards, HASH_OPS * n)
        rec = {"n": n, "n_shards": n_shards, "base": base,
               "identical": identical, "max_abs_err": max_abs_err(got, want),
               "launches": hash_route.launches - launches0, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        results[("hash_route", n, n_shards)] = rec
        emit("kernel:hash_route", **rec)


def _payload(ids: np.ndarray) -> np.ndarray:
    """Payload words of op ``ids``: word 0 is the id, words 1-3 are mixes
    of it, so a dequeued element can be checked whole on the host."""
    u = ids.astype(np.uint64)
    words = [u, (u * 2654435761) & 0xFFFFFFFF, (u ^ 0x5BD1E995) + 7,
             (u * 40503 + 1) & 0xFFFFFFFF]
    return np.stack([w.astype(np.uint32).view(np.int32) for w in words], -1)


class FifoChecker:
    """Host-side FIFO model: expected dequeue ids and ⊥ set per burst,
    from numpy arithmetic independent of the code under test."""

    def __init__(self):
        self.expected = deque()      # arrays of enqueued ids, in order
        self.size = 0
        self.next_id = 0
        self.n_enq = self.n_deq = 0  # positions handed out so far

    @property
    def pending(self) -> int:
        return sum(b.size for b in self.expected)

    def stage(self, K: int, nL: int, p_enq: float, rng):
        E = rng.random((K, nL)) < p_enq
        V = np.ones((K, nL), bool)
        ids = np.arange(self.next_id, self.next_id + K * nL, dtype=np.int64)
        self.next_id += K * nL
        return E, V, _payload(ids).reshape(K, nL, 4)

    def verify(self, E, V, P, pos, m, dv, dok, ovf):
        e, v = E.reshape(-1), V.reshape(-1)
        deq = v & ~e
        # reflected walk: a dequeue is ⊥ exactly when the queue is empty
        step = np.where(v & e, 1, np.where(deq, -1, 0))
        walk = self.size + np.cumsum(step)
        floor = np.maximum.accumulate(np.maximum(-walk, 0))
        prev = np.concatenate([[0], floor[:-1]])
        bottom = deq & (floor > prev)
        m, dok, pos = m.reshape(-1), dok.reshape(-1), pos.reshape(-1)
        check(not ovf.any(), "no overflow")
        check(np.array_equal(m, v & ~bottom), "⊥ set matches the FIFO model")
        check(np.array_equal(dok, deq & ~bottom),
              "every matched dequeue found its element (none lost)")
        n_deq = int(dok.sum())
        got_ids = dv.reshape(-1, 4)[dok]
        enq_ids = P.reshape(-1, 4)[v & e, 0].astype(np.int64)
        # expected dequeue ids: the queue's head, then this burst's enqueues
        # (a same-burst dequeue may take an element enqueued before it)
        self.expected.append(enq_ids)
        head = []
        need = n_deq
        while need:
            blk = self.expected[0]
            take = min(need, blk.size)
            head.append(blk[:take])
            if take == blk.size:
                self.expected.popleft()
            else:
                self.expected[0] = blk[take:]
            need -= take
        want = np.concatenate(head) if head else np.zeros(0, np.int64)
        check(np.array_equal(got_ids, _payload(want)),
              "dequeued elements are exactly the next ids in FIFO order")
        n_enq = int((v & e).sum())
        check(np.array_equal(pos[v & e], np.arange(self.n_enq,
                                                   self.n_enq + n_enq)),
              "enqueue positions are the next consecutive positions")
        check(np.array_equal(pos[dok], np.arange(self.n_deq,
                                                 self.n_deq + n_deq)),
              "dequeue positions are the next consecutive positions")
        check((pos[~m] == -1).all(), "⊥ and invalid ops carry position -1")
        self.n_enq += n_enq
        self.n_deq += n_deq
        self.size += n_enq - n_deq
        return {"enq": n_enq, "deq": n_deq, "bottom": int(bottom.sum())}


def phase_elastic(torch, rng, results):
    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.segscan import queue_scan
    dev = torch.device("cuda")
    N, CAP, W, L, K = 64, 65_536, 4, 1_024, 16
    torch.cuda.reset_peak_memory_stats()
    eq = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                            device="cuda")
    rt = eq.runtime
    model = FifoChecker()
    kept = []          # host outputs of the first two bursts
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    bursts = []
    queue_scan.launches = hash_route.launches = 0

    def burst(p_enq):
        nL = eq.n_shards * L
        E, V, P = model.stage(K, nL, p_enq, rng)
        args = [torch.from_numpy(x).to(dev) for x in (E, V, P)]
        x0, s0 = rt.n_exchanges, queue_scan.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eq.run_waves(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rt.n_exchanges - x0 == K + 1, "K+1 exchanges per burst")
        check(queue_scan.launches - s0 == K, "one scan launch per wave")
        host = [o.cpu().numpy() for o in out]
        rec = model.verify(E, V, P, *host)
        check(eq.size == model.size, "queue size matches the FIFO model")
        if len(kept) < 2:
            kept.append((E, V, P, host))
        timing["waves"] += K
        timing["seconds"] += dt
        timing["ops"] += K * nL
        bursts.append({"n_shards": eq.n_shards, "p_enq": p_enq,
                       "seconds": dt, **rec, "size": eq.size})

    migrations = []

    def migrate(fn, *a):
        x0 = rt.n_exchanges
        size = eq.size
        st = fn(*a)
        check(st["moved"] == size == eq.size, "moved == size")
        check(rt.n_exchanges - x0 == 1, "one exchange per migration")
        migrations.append({k: st[k] for k in ("kind", "P_from", "P_to",
                                              "moved", "bytes_moved",
                                              "wave_s", "total_s")})

    while eq.size < 1_000_000:
        burst(0.65)
    backlog = eq.size
    migrate(eq.shrink, list(range(48, 64)))               # LEAVE 16
    burst(0.5)
    migrate(eq.grow, 16)                                   # JOIN 16
    while eq.size > 0:
        burst(0.0)
    launches = queue_scan.launches
    check(launches > 0, "the main path launched the queue-scan kernel")
    check(eq.size == 0 and model.pending == 0, "queue drained")
    peak = torch.cuda.max_memory_allocated()
    del eq

    # the first two bursts again, sequential schedule: bit-identical
    seq = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                             pipelined=False, device="cuda")
    for E, V, P, host in kept:
        x0 = seq.runtime.n_exchanges
        out = seq.run_waves(*(torch.from_numpy(x).to(dev) for x in (E, V, P)))
        check(seq.runtime.n_exchanges - x0 == 2 * K, "2K exchanges "
              "per sequential burst")
        check(all(np.array_equal(o.cpu().numpy(), h)
                  for o, h in zip(out, host)),
              "pipelined and sequential bursts bit-identical")
    del seq
    rec = {"n_shards": N, "cap": CAP, "payload_width": W,
           "ops_per_shard": L, "K": K, "backlog_max": backlog,
           "bursts": len(bursts), "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "migrations": migrations, "queue_scan_launches": launches,
           "max_memory_allocated": peak, "fifo_order": "ok",
           "sequential_equals_pipelined": True, "burst_log": bursts}
    results["elastic_fifo"] = rec
    emit("path:elastic_fifo", **rec)


def phase_profile(torch, rng, results):
    """One pipelined 16-wave burst at full size under torch.profiler:
    device time by operation, and the device's busy share of the burst's
    wall time.  Reports "not measured" where the profiler sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dqueue import ElasticDeviceQueue
    dev = torch.device("cuda")
    eq = ElasticDeviceQueue(64, cap=65_536, payload_width=4,
                            ops_per_shard=1_024, device="cuda")
    model = FifoChecker()
    staged = [[torch.from_numpy(x).to(dev)
               for x in model.stage(16, 64 * 1_024, 0.5, rng)]
              for _ in range(2)]
    eq.run_waves(*staged[0])                   # warm-up burst
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eq.run_waves(*staged[1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels are the CUDA-side events; host-side operators carry their
    # kernels' time as self device time.  Spans are skipped on both sides:
    # a span also shows as one device-side range over everything inside,
    # and counting it would count the burst's kernels twice.
    evs = [ev for ev in prof.key_averages()
           if not ev.key.startswith(("wave:", "membership:"))]
    busy = sum(ev.self_device_time_total for ev in evs
               if ev.device_type == DeviceType.CUDA)
    check(busy <= wall_us, f"device busy {busy} us within the burst's wall "
                           f"time {wall_us} us (one stream, nothing counted "
                           f"twice)")
    ops = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in evs
                  if ev.device_type != DeviceType.CUDA
                  and ev.self_device_time_total > 0), reverse=True)
    rec = {"burst": "K=16, 64 shards x 1024 ops, 50% enqueue",
           "wall_ms": wall_us / 1e3,
           "device_ms": busy / 1e3 if busy else "not measured",
           "busy_share": busy / wall_us if busy else "not measured",
           "top_ops": [{"op": k, "device_ms": dt / 1e3, "calls": c}
                       for dt, k, c in ops[:10]]}
    results["profile"] = rec
    emit("profile", **rec)


def phase_hash_balance(torch, rng, results):
    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.kernels.hash_route import hash_route, hash_route_ref
    from repro_torch.kernels.segscan import queue_scan
    dev = torch.device("cuda")
    eq = ElasticDeviceQueue(8, cap=16_384, payload_width=4,
                            ops_per_shard=1_024, device="cuda")
    model = FifoChecker()
    E, V, P = model.stage(16, 8 * 1_024, 0.65, rng)
    host = [o.cpu().numpy() for o in
            eq.run_waves(*(torch.from_numpy(x).to(dev) for x in (E, V, P)))]
    model.verify(E, V, P, *host)
    lo, hi = int(eq.state.first), int(eq.state.last)
    check(0 < hi - lo + 1 <= 65_536, "live set small enough for the report")
    queue_scan.launches = hash_route.launches = 0
    st = eq.shrink([6, 7])
    launches = hash_route.launches
    check(launches > 0, "the migration launched the hash-route kernel")
    check(st["moved"] == eq.size, "moved == size")
    pos = torch.arange(lo, hi + 1, dtype=torch.int32)
    _, want = hash_route_ref(pos, torch.ones(pos.shape[0], dtype=torch.bool),
                             6)
    hb = st["hash_balance"]
    check(hb["counts"] == want.tolist(),
          "hash_balance counts equal the plain version's")
    # the kernel against its plain version at the path's own shape, both
    # outputs (owner and counts) on the same device tensors
    n = hi - lo + 1
    pos_d = pos.to(dev)
    valid_d = torch.ones(n, dtype=torch.bool, device=dev)
    got = hash_route(pos_d, valid_d, 6)
    want = hash_route_ref(pos_d, valid_d, 6)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(got, want))
    check(identical, f"hash_route n={n} n_shards=6 owner and counts "
                     f"identical to the plain version")
    err = max_abs_err(got, want)
    ms = time_ms(lambda: hash_route(pos_d, valid_d, 6), 100, torch)
    plain = time_ms(lambda: hash_route_ref(pos_d, valid_d, 6), 20, torch)
    b_ms, b_by = bound(9 * n + 24, HASH_OPS * n)
    rec = {"n_shards": "8->6", "n": n, "hash_balance": hb,
           "hash_route_launches": launches, "identical": identical,
           "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err}
    results["hash_balance"] = rec
    emit("path:hash_balance", **rec)


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the GPU and never falls back to the CPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    rng = np.random.default_rng(args.seed)
    results = {}
    phase_build()
    phase_queue_scan(torch, rng, results)
    phase_hash_route(torch, rng, results)
    phase_elastic(torch, rng, results)
    phase_profile(torch, rng, results)
    phase_hash_balance(torch, rng, results)
    qs, hb = results[("queue_scan", 65_536)], results["hash_balance"]
    kernels = [
        {"name": "queue_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segscan.cu",
         "replaces": "src/repro/kernels/segscan/kernel.py:244",
         "path": "elastic_fifo", "shape": "n=65536 (one wave)",
         "launches": results["elastic_fifo"]["queue_scan_launches"],
         "matched_plain": qs["bit_identical"],
         "max_abs_err": qs["max_abs_err"],
         "ms": qs["ms"], "plain_ms": qs["plain_ms"],
         "bound_ms": qs["bound_ms"], "bound_by": qs["bound_by"],
         "library_ms": None},
        {"name": "hash_route", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_route.cu",
         "replaces": "src/repro/kernels/hash_route/kernel.py:49",
         "path": "hash_balance", "shape": f"n={hb['n']}, 6 shards",
         "launches": hb["hash_route_launches"],
         "matched_plain": hb["identical"],
         "max_abs_err": hb["max_abs_err"], "ms": hb["ms"],
         "plain_ms": hb["plain_ms"], "bound_ms": hb["bound_ms"],
         "bound_by": hb["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
