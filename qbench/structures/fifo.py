"""The distributed FIFO queue: ``repro_torch.dqueue.ElasticDeviceQueue``.

Configuration keys: ``n_shards``, ``pool_size``, ``cap``,
``payload_width``, ``ops_per_shard``.
"""
from __future__ import annotations

from qbench.reference.fifo import FifoModel

SPAN = "queue:burst"          # the port's span around a burst's issue
PER_OP = ("pos", "matched", "deq_ok")
PER_WAVE = ("overflow",)


def build(cfg: dict, device):
    """The structure under test, empty, on ``device``."""
    from repro_torch.dqueue import ElasticDeviceQueue
    return ElasticDeviceQueue(
        cfg["n_shards"], cap=cfg["cap"], payload_width=cfg["payload_width"],
        ops_per_shard=cfg["ops_per_shard"],
        pool_size=cfg.get("pool_size", cfg["n_shards"]), device=device)


def draw_extra(stream, shape, cfg: dict) -> dict:
    """No inputs beside the op bits and the payload."""
    return {}


def run(q, burst) -> dict:
    """One burst through ``run_waves``; its outputs, on the device."""
    pos, matched, deq_vals, deq_ok, ovf = q.run_waves(
        burst.is_enq, burst.valid, burst.payload)
    return {"pos": pos, "matched": matched, "deq_vals": deq_vals,
            "deq_ok": deq_ok, "overflow": ovf}


def model(cfg: dict, max_burst: int, device) -> FifoModel:
    """The plain model of the queue's answers, on ``device``."""
    return FifoModel(cfg.get("pool_size", cfg["n_shards"]) * cfg["cap"],
                     max_burst, device)


def expect(m: FifoModel, cfg: dict, inputs: dict, answers: bool) -> dict:
    """The model's answers to a burst's inputs."""
    return m.burst(inputs["is_enq"], inputs["valid"], inputs["ids"],
                   inputs["n_shards"] * cfg["cap"], answers=answers)
