"""The controls: the plain model put in the program's place with one
guarantee of the configuration broken, which the judgement has to refuse.

The configurations state no precision, so each control breaks a stated
guarantee in the way a faster implementation might be tempted to:

* FIFO (``fifo``): the ops of a wave are taken in op-major order (op j of
  every shard before op j + 1 of any) instead of the shard-major order the
  queue guarantees, a per-shard counter in place of the one global scan;
* priority (``priority``): one tier more of relaxation than the
  configuration states.

``python3 qbench/control.py --workload <cell> --seeds a,b,c --seconds s``
runs a cell with its control in the program's place on the card and
prints each run's compared numbers; the tests run the same at the CPU's
size.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

from qbench.reference.fifo import FifoModel  # noqa: E402
from qbench.reference.payload import words  # noqa: E402
from qbench.reference.priority import PriorityModel  # noqa: E402


class _StandIn:
    """The elastic structure's surface the harness drives: shard count,
    size, ``grow``/``shrink`` and ``run_waves``."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.n_shards = int(cfg["n_shards"])
        self.pool = int(cfg.get("pool_size", self.n_shards))
        self.W = int(cfg["payload_width"])
        self.m = None                     # made at the first burst

    @property
    def size(self) -> int:
        return 0 if self.m is None else self.m.size

    def model(self, K: int):
        """The model, sized for bursts of ``K`` waves at the full pool."""
        if self.m is None:
            self.m = self.make(self.pool * self.cfg["cap"],
                               K * self.pool * self.cfg["ops_per_shard"])
        return self.m

    def bucket_widths(self) -> tuple:
        """The wave widths the program's ladder offers."""
        L = int(self.cfg["ops_per_shard"])
        return tuple(sorted({max(1, L // 4), max(1, L // 2), L}))

    def pick_width(self, n_ops: int) -> int:
        """The narrowest width whose wave holds ``n_ops``."""
        for w in self.bucket_widths():
            if self.n_shards * w >= n_ops:
                return w
        return self.bucket_widths()[-1]

    def grow(self, k: int) -> dict:
        self.n_shards += k
        return {"kind": "grow", "wave_s": 0.0}

    def shrink(self, ids) -> dict:
        self.n_shards -= len(ids)
        return {"kind": "shrink", "wave_s": 0.0}

    @staticmethod
    def ids_of(payload: torch.Tensor) -> torch.Tensor:
        """Each op's id from its payload's first word (the id modulo
        2^32)."""
        return torch.remainder(payload[..., 0].long(), 1 << 32)

    def vals(self, ok: torch.Tensor, deq_ids: torch.Tensor) -> torch.Tensor:
        v = torch.zeros(ok.shape + (self.W,), dtype=torch.int32,
                        device=ok.device)
        v[ok] = words(deq_ids[ok], self.W)
        return v


class FifoOpMajor(_StandIn):
    """The FIFO model over each wave's ops in op-major order."""

    def make(self, max_live: int, max_burst: int):
        return FifoModel(max_live, max_burst, self.device)

    def run_waves(self, is_enq, valid, payload):
        K, n = is_enq.shape
        L = n // self.n_shards

        def op_major(x):
            return x.view(K, self.n_shards, L, *x.shape[2:]).transpose(
                1, 2).reshape(K, n, *x.shape[2:])

        def back(x):
            return x.view(K, L, self.n_shards, *x.shape[2:]).transpose(
                1, 2).reshape(K, n, *x.shape[2:])
        a = self.model(K).burst(op_major(is_enq), op_major(valid),
                                op_major(self.ids_of(payload)),
                                self.n_shards * self.cfg["cap"])
        ok = back(a["deq_ok"])
        return (back(a["pos"]), back(a["matched"]),
                self.vals(ok, back(a["deq_ids"])), ok, a["overflow"])


class PriorityLooser(_StandIn):
    """The priority model with one tier more of relaxation."""

    def make(self, max_live: int, max_burst: int):
        return PriorityModel(self.cfg["n_prios"], self.cfg["relaxation"] + 1,
                             max_live, max_burst, self.device)

    def run_waves(self, is_enq, valid, prio, payload):
        a = self.model(is_enq.shape[0]).burst(
            is_enq, valid, prio, self.ids_of(payload), self.n_shards,
            self.n_shards * self.cfg["cap"])
        return (a["tier"], a["pos"], a["matched"],
                self.vals(a["deq_ok"], a["deq_ids"]), a["deq_ok"],
                a["overflow"], a["n_relaxed"])


CONTROLS = {"fifo": FifoOpMajor, "priority": PriorityLooser}


def build(cfg: dict, device):
    """The control of ``cfg``'s structure, in the program's place."""
    return CONTROLS[cfg["structure"]](cfg, device)


def main(argv=None) -> int:
    from qbench import harness
    ap = argparse.ArgumentParser(description="run a cell's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(root, args.workload, seed, args.seconds, False,
                             device="cuda", build=build)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "run": r["run"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
