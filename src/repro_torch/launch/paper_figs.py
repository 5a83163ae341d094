"""Paper-evaluation runs: Figures 2, 3 and 4 of the SKUEUE paper.

  python -m repro_torch.launch.paper_figs [--full]

Counterpart of ``benchmarks/paper_figs.py``, through the port's protocol
engine (:class:`repro_torch.core.protocol.Skueue`), which is host code: no
device is used.  Same protocol as the paper's Sec. VII setup: per
synchronous round, generate requests at random nodes; after the generation
window, drain; report the average number of rounds per request.  Default
sizes are scaled down (``--full`` approaches the paper's 10^5 nodes / 1000
rounds).  Prints ``figure,n,x,avg_rounds_per_request,requests`` CSV rows,
``x`` being the ENQUEUE (PUSH) ratio for Figs. 2-3 and the per-node rate
for Fig. 4.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.consistency import check_sequential_consistency
from ..core.protocol import DEQ, ENQ, Skueue


def _run_instance(n, mode, p_enq, rounds, per_round, seed=0,
                  rate_per_node=None):
    sk = Skueue(n, mode=mode, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def inject(s, rnd):
        if rnd > rounds:
            return
        nids = s.ring.node_ids()
        k = (per_round if rate_per_node is None
             else rng.binomial(len(nids), rate_per_node))
        for _ in range(k):
            s.inject(nids[int(rng.integers(len(nids)))],
                     ENQ if rng.random() < p_enq else DEQ)

    sk.run_rounds(rounds, inject_fn=inject)
    check_sequential_consistency(sk)
    lat = [r.t_done - r.t_issue for r in sk.requests if r.t_done >= 0]
    return float(np.mean(lat)), len(lat)


def fig2_queue(full=False):
    """Avg rounds/request vs n for ENQUEUE ratios p (paper Fig. 2)."""
    ns = [4, 16, 64, 256, 1024] + ([4096] if full else [])
    rounds = 300 if full else 80
    rows = []
    for p in (0.25, 0.5, 0.75):
        for n in ns:
            m, cnt = _run_instance(n, "queue", p, rounds, per_round=10,
                                   seed=n)
            rows.append(("fig2_queue", n, p, m, cnt))
    return rows


def fig3_stack(full=False):
    """Avg rounds/request vs n for PUSH ratios p (paper Fig. 3)."""
    ns = [4, 16, 64, 256] + ([1024] if full else [])
    rounds = 300 if full else 80
    rows = []
    for p in (0.0, 0.5, 0.75):
        for n in ns:
            m, cnt = _run_instance(n, "stack", p, rounds, per_round=10,
                                   seed=n + 7)
            rows.append(("fig3_stack", n, p, m, cnt))
    return rows


def fig4_rate(full=False):
    """Avg rounds/request vs per-node request rate at fixed n (paper Fig. 4:
    the stack IMPROVES with rate thanks to local push/pop combining)."""
    n = 1024 if full else 128
    rounds = 120 if full else 60
    rows = []
    for rate in (0.05, 0.25, 1.0):
        for mode in ("queue", "stack"):
            m, cnt = _run_instance(n, mode, 0.5, rounds, per_round=0,
                                   seed=int(rate * 100),
                                   rate_per_node=rate)
            rows.append((f"fig4_{mode}", n, rate, m, cnt))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sizes (slow)")
    args = ap.parse_args(argv)
    print("figure,n,x,avg_rounds_per_request,requests", flush=True)
    for fig in (fig2_queue, fig3_stack, fig4_rate):
        for name, n, x, mean_rounds, cnt in fig(full=args.full):
            print(f"{name},{n},{x},{mean_rounds!r},{cnt}", flush=True)


if __name__ == "__main__":
    main()
