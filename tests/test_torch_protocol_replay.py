"""The CPU twin of ``chip_smoke.py``'s ``path:protocol_replay``: the
port's ``Skueue`` (queue, and stack with local combining) through JOIN,
LEAVE (the anchor's process among the leavers) and quiescence, checked
by the port's consistency checker, then its total order ≺ replayed
through the port's ``ElasticDeviceQueue`` and ``ElasticDeviceStack`` on
``device="cpu"`` with a LEAVE and a JOIN between waves.  Positions, ⊥
flags and dequeued elements must be the protocol's, with no overflow,
``moved == size`` at each migration and one scan launch a wave.  The
smoke's own helpers run here (at 8 processes, 4 shards of 4 ops), so the
code the card runs is rehearsed on the CPU."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro.core.consistency import check_sequential_consistency as ref_check
from repro.core.protocol import Skueue as RefSkueue

from repro_torch.dqueue import ElasticDeviceQueue, ElasticDeviceStack
from repro_torch.kernels.segscan import queue_scan, stack_scan

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N, ROUNDS, JOINS, LEAVE = 8, 40, {10: 2, 20: 1}, (25, 3)
PLAN = {2: ("shrink", [4, 5]), 4: ("grow", 2)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["queue", "stack"])
def test_replay_of_protocol_order_equals_protocol(mode, seed):
    sk, proto = smoke.protocol_run(mode, seed, n=N, rounds=ROUNDS,
                                   joins=JOINS, leave=LEAVE)
    assert proto["update_phases"] > 0 and proto["pending_membership"] == 0
    if mode == "stack":
        assert 0 < proto["locally_paired"] < proto["requests"]
    cls = ElasticDeviceQueue if mode == "queue" else ElasticDeviceStack
    kw = {"slot_depth": 4} if mode == "stack" else {}
    es = cls(6, cap=256, payload_width=4, ops_per_shard=4, device="cpu",
             **kw)
    scan = queue_scan if mode == "queue" else stack_scan
    scan.launches = 0
    rep = smoke.replay_protocol(torch, sk, es, PLAN)
    assert rep["waves"] > max(PLAN), "a wave runs after each migration"
    assert [m["kind"] for m in rep["migrations"]] == ["shrink", "grow"]
    assert rep["ops"] == proto["global_requests"] and rep["bottom"] > 0
    assert scan.launches == 0   # CPU tensors take the plain version


def test_smoke_protocol_run_equals_reference_protocol():
    """The smoke's schedule on the port's Skueue gives the reference's
    records (the reference driven through the same schedule)."""
    sk, proto = smoke.protocol_run("queue", 3, n=N, rounds=ROUNDS,
                                   joins=JOINS, leave=LEAVE)
    ref, ref_proto = smoke.protocol_run("queue", 3, n=N, rounds=ROUNDS,
                                        joins=JOINS, leave=LEAVE,
                                        impl=(RefSkueue, ref_check))
    assert [vars(r) for r in sk.requests] == [vars(r) for r in ref.requests]
    drop = ("host_sim_s", "host_check_s")
    assert {k: v for k, v in proto.items() if k not in drop} == \
        {k: v for k, v in ref_proto.items() if k not in drop}
