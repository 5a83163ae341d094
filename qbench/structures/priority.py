"""The P-tier priority queue, strict or relaxed:
``repro_torch.dqueue.ElasticDevicePriorityQueue``.

Configuration keys: ``n_shards``, ``pool_size``, ``n_prios``,
``relaxation``, ``cap`` (slots a shard holds for each tier),
``payload_width``, ``ops_per_shard`` and ``tier_shares`` (the share of
enqueues that goes to each tier, most urgent first).
"""
from __future__ import annotations

import torch

from qbench.reference.priority import PriorityModel

SPAN = "pqueue:burst"
PER_OP = ("tier", "pos", "matched", "deq_ok")
PER_WAVE = ("overflow", "n_relaxed")


def build(cfg: dict, device):
    """The structure under test, empty, on ``device``."""
    from repro_torch.dqueue import ElasticDevicePriorityQueue
    return ElasticDevicePriorityQueue(
        cfg["n_shards"], n_prios=cfg["n_prios"],
        relaxation=cfg["relaxation"], cap=cfg["cap"],
        payload_width=cfg["payload_width"],
        ops_per_shard=cfg["ops_per_shard"],
        pool_size=cfg.get("pool_size", cfg["n_shards"]), device=device)


def draw_extra(stream, shape, cfg: dict) -> dict:
    """Each op's tier, drawn from ``tier_shares`` (dequeues ignore it)."""
    shares = torch.tensor(cfg["tier_shares"], dtype=torch.float64)
    bounds = (torch.cumsum(shares, 0) / shares.sum())[:-1]
    u = stream.uniform(shape)
    prio = torch.bucketize(u, bounds.to(u.dtype).to(u.device))
    return {"prio": prio.to(torch.int32)}


def run(q, burst) -> dict:
    """One burst through ``run_waves``; its outputs, on the device."""
    tier, pos, matched, deq_vals, deq_ok, ovf, n_relaxed = q.run_waves(
        burst.is_enq, burst.valid, burst.extra["prio"],
        burst.payload)
    return {"tier": tier, "pos": pos, "matched": matched,
            "deq_vals": deq_vals, "deq_ok": deq_ok, "overflow": ovf,
            "n_relaxed": n_relaxed}


def model(cfg: dict, max_burst: int, device) -> PriorityModel:
    """The plain model of the queue's answers, on ``device``."""
    return PriorityModel(cfg["n_prios"], cfg["relaxation"],
                         cfg.get("pool_size", cfg["n_shards"]) * cfg["cap"],
                         max_burst, device)


def expect(m: PriorityModel, cfg: dict, inputs: dict, answers: bool) -> dict:
    """The model's answers to a burst's inputs."""
    return m.burst(inputs["is_enq"], inputs["valid"], inputs["prio"],
                   inputs["ids"], inputs["n_shards"],
                   inputs["n_shards"] * cfg["cap"], answers=answers)
