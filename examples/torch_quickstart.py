"""Quickstart for the PyTorch port: the SKUEUE distributed queue.

1. the paper-faithful protocol on the LDB overlay (async message passing),
2. the same queue as one position scan on the device,
3. the sharded device queue (Stage 4 as an exchange), one wave.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(default device ``cuda``; it raises where there is none).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.consistency import check_sequential_consistency
from repro_torch.core.protocol import DEQ, ENQ, Skueue
from repro_torch.core.scan_queue import QueueState, queue_scan
from repro_torch.dqueue import DeviceQueue


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    # --- 1. the protocol, as published (host bookkeeping) -------------------
    sk = Skueue(n=8, mode="queue", seed=0)
    rng = np.random.default_rng(0)
    nids = sk.ring.node_ids()
    for _ in range(40):
        sk.inject(nids[int(rng.integers(len(nids)))],
                  ENQ if rng.random() < 0.6 else DEQ)
    sk.run_async()  # adversarial asynchronous delivery
    stats = check_sequential_consistency(sk)
    print(f"[protocol] {stats['n_requests']} requests sequentially "
          f"consistent under async delivery; {stats['total_msgs']} messages")

    # --- 2. the same queue as ONE position scan on the device ---------------
    is_enq = torch.from_numpy(rng.random(1000) < 0.6).to(dev)
    pos, matched, state = queue_scan(is_enq, QueueState.empty(dev))
    size = int(state.last) - int(state.first) + 1
    print(f"[scan]     1000 requests assigned in one scan on {dev}; "
          f"queue size now {size}; {int(matched.sum())} matched")

    # --- 3. sharded element store (Stage 4 as an exchange), one wave --------
    dq = DeviceQueue(4, cap=256, payload_width=2, ops_per_shard=32,
                     device=dev)
    st = dq.init_state()
    n = dq.n_shards * dq.L
    is_enq = np.zeros(n, bool)
    valid = np.zeros(n, bool)
    payload = np.zeros((n, 2), np.int32)
    for i in range(10):         # enqueue 10 elements...
        is_enq[i] = valid[i] = True
        payload[i] = (i, i * i)
    for i in range(10, 15):     # ...and dequeue 5, in the same wave
        valid[i] = True
    st, pos, matched, dv, dok, _ = dq.step(
        st, *(torch.from_numpy(x).to(dev) for x in (is_enq, valid, payload)))
    dv, dok = dv.cpu().numpy(), dok.cpu().numpy()
    got = [tuple(map(int, dv[i])) for i in range(n) if dok[i]]
    left = int(st.last) - int(st.first) + 1
    print(f"[device]   dequeued {got} (FIFO) on {dev}, {left} left in store")


if __name__ == "__main__":
    main()
