"""The port's runtime seam against the JAX package's.

``select_devices``, ``LatencyModel`` and ``SimRuntime``'s charging rules
are held against ``repro.runtime`` itself (pure host arithmetic, imported
directly): the same cases the reference pins, and the charges an elastic
queue on a ``SimRuntime`` makes over steps, bursts and migrations
replayed on the reference's ``SimRuntime``.  A scheduled failure drives a
LEAVE through the port's ``run_with_restarts`` with the ``SimRuntime`` as
the injector, and a regrow JOIN never hands back the failed id.  The
structures on a ``SimRuntime`` give the same outputs as on a
``LocalRuntime``.  ``exchange_bytes`` counts the send buffers' bytes to
the closed form of a step, a pipelined and a sequential burst and a
migration, on both, and the burst span records it.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro.runtime import LatencyModel as JLatencyModel
from repro.runtime import SimRuntime as JSimRuntime
from repro.runtime import select_devices as j_select_devices

from repro_torch.dqueue import (DeviceQueue, ElasticDeviceQueue,
                                ElasticDeviceStack)
from repro_torch.dqueue.wave_engine import fanout_bound
from repro_torch.fault import (FailureInjector, elastic_queue_policy,
                               run_with_restarts)
from repro_torch.runtime import (LatencyModel, LocalRuntime, ProcessRole,
                                 SimRuntime, VirtualShard, select_devices)


class _FakeDev:
    def __init__(self, i):
        self.id = i


@pytest.mark.parametrize("n, exclude", [(3, ()), (3, (0,)), (3, (0, 2)),
                                        (7, (5,)), (8, ())])
def test_select_devices_matches_reference(n, exclude):
    shards = [VirtualShard(i) for i in range(8)]
    fakes = [_FakeDev(i) for i in range(8)]
    got = [d.id for d in select_devices(shards, n, exclude)]
    assert got == [d.id for d in j_select_devices(fakes, n, exclude)]
    # a shard object works as an exclusion too
    got = [d.id for d in select_devices(shards, n,
                                        [shards[i] for i in exclude])]
    assert got == [d.id for d in j_select_devices(fakes, n, exclude)]


@pytest.mark.parametrize("n, exclude", [(4, (2,)), (5, ()), (0, ()),
                                        (5, (9,))])
def test_select_devices_error_names_the_excluded_id(n, exclude):
    shards = [VirtualShard(i) for i in range(4)]
    fakes = [_FakeDev(i) for i in range(4)]
    with pytest.raises(ValueError) as ours:
        select_devices(shards, n, exclude)
    with pytest.raises(ValueError) as ref:
        j_select_devices(fakes, n, exclude)
    assert str(ours.value) == str(ref.value)
    if exclude == (2,):
        assert "device id(s) [2]" in str(ours.value)
        assert "3 of 4" in str(ours.value)
    else:
        assert "device id" not in str(ours.value)


LATENCY_CASES = [
    (dict(base_us=100.0, per_mib_us=8.0,
          per_collective={"all_reduce": {"base_us": 40.0}}),
     [("all_to_all", 0), ("all_to_all", 1 << 20), ("all_reduce", 1 << 19),
      ("all_gather", 12345)]),
    (dict(), [("all_to_all", 1 << 30), ("all_reduce", 4)]),
    (dict(base_us=25.0, per_mib_us=80.0,
          per_collective={"all_to_all": {"per_mib_us": 3.0},
                          "all_reduce": {"base_us": 1.5,
                                         "per_mib_us": 0.25}}),
     [("all_to_all", 50_331_648), ("all_reduce", 4), ("x", 7)]),
]


@pytest.mark.parametrize("kw, calls", LATENCY_CASES)
def test_latency_model_matches_reference(kw, calls):
    ours, ref = LatencyModel(**kw), JLatencyModel(**kw)
    for kind, nbytes in calls:
        assert ours.latency_s(kind, nbytes) == ref.latency_s(kind, nbytes)
    assert LatencyModel().latency_s("all_to_all", 1 << 30) == 0.0
    m = LatencyModel(**LATENCY_CASES[0][0])
    assert m.latency_s("all_to_all", 0) == pytest.approx(100e-6)
    assert m.latency_s("all_to_all", 1 << 20) == pytest.approx(108e-6)
    assert m.latency_s("all_reduce", 1 << 19) == pytest.approx(44e-6)


@pytest.mark.parametrize("K", [1, 4, 9])
@pytest.mark.parametrize("pipelined", [True, False])
def test_burst_launches_match_reference(K, pipelined):
    assert (SimRuntime.burst_launches(K, pipelined)
            == JSimRuntime.burst_launches(K, pipelined)
            == (K + 1 if pipelined else 2 * K))


@pytest.mark.parametrize("n, width, W", [(8, 2, 2), (4, 16, 4),
                                         (64, 1024, 4)])
def test_wave_envelope_matches_reference(n, width, W):
    assert (SimRuntime.wave_envelope_bytes(n, width, W)
            == JSimRuntime.wave_envelope_bytes(n, width, W)
            == n * width * 4 * (2 + W))


class _Recorder(SimRuntime):
    """A SimRuntime that also logs each charge hook's arguments."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def on_burst(self, *a, **kw):
        self.log.append(("burst", a, kw))
        super().on_burst(*a, **kw)

    def on_migration(self, stats):
        self.log.append(("migration", dict(stats)))
        super().on_migration(stats)


def _replay(log, lat_kw):
    ref = JSimRuntime(latency=JLatencyModel(**lat_kw))
    for entry in log:
        if entry[0] == "burst":
            ref.on_burst(*entry[1], **entry[2])
        else:
            ref.on_migration(dict(entry[1]))
    return ref


@pytest.mark.parametrize("kind", ["queue", "stack"])
def test_sim_runtime_charges_match_reference(kind):
    lat_kw = dict(base_us=100.0, per_mib_us=8.0,
                  per_collective={"all_reduce": {"base_us": 40.0}})
    sim = _Recorder(8, LatencyModel(**lat_kw), device="cpu")
    cls = {"queue": ElasticDeviceQueue, "stack": ElasticDeviceStack}[kind]
    q = cls(4, cap=16, payload_width=2, ops_per_shard=4, runtime=sim)
    n = q.n_shards * q.L
    z = np.zeros(n, bool)
    q.step(z, z, np.zeros((n, 2), np.int32))
    env = SimRuntime.wave_envelope_bytes(4, 4, 2)
    assert sim.counts == {"all_to_all": 2}
    assert sim.bytes_by_kind == {"all_to_all": 2 * env}
    K = 4
    e = np.ones((K, n), bool)
    pw = np.arange(K * n * 2, dtype=np.int32).reshape(K, n, 2)
    q.run_waves(e, e, pw)
    assert sim.counts == {"all_to_all": 7}
    mig = q.grow(2)
    assert mig["sim_s"] > 0 and sim.counts["all_reduce"] == 2
    assert mig["sim_s"] == pytest.approx(
        LatencyModel(**lat_kw).latency_s("all_to_all", mig["bytes_moved"])
        + 2 * LatencyModel(**lat_kw).latency_s("all_reduce", 4), abs=0)
    q.shrink([0, 5])
    ref = _replay(sim.log, lat_kw)
    assert sim.sim_time_s == ref.sim_time_s
    assert sim.counts == ref.counts
    assert sim.bytes_by_kind == ref.bytes_by_kind
    snap = sim.snapshot()
    assert snap["sim_time_s"] == sim.sim_time_s and snap["kind"] == "sim"
    assert snap["collectives"] == ref.snapshot()["collectives"]
    assert snap["latency"] == ref.snapshot()["latency"]


@pytest.mark.parametrize("pipelined", [True, False])
def test_structures_on_sim_runtime_match_local(pipelined):
    rng = np.random.default_rng(3)
    K, n = 3, 4 * 4
    ops = [(rng.random((K, n)) < 0.6, rng.random((K, n)) < 0.9,
            rng.integers(0, 1 << 20, (K, n, 2)).astype(np.int32))
           for _ in range(3)]

    def drive(rt):
        q = DeviceQueue(4, cap=16, payload_width=2, ops_per_shard=4,
                        pipelined=pipelined, runtime=rt)
        st, outs = q.init_state(), []
        for E, V, P in ops:
            st, *o = q.run_waves(st, torch.from_numpy(E),
                                 torch.from_numpy(V), torch.from_numpy(P))
            outs.append([x.numpy() for x in o])
        return outs, [x.numpy() for x in st]
    a = drive(LocalRuntime(4, device="cpu"))
    sim = SimRuntime(4, LatencyModel(base_us=5.0), device="cpu")
    b = drive(sim)
    for ox, oy in zip(a[0], b[0]):
        assert all(np.array_equal(x, y) for x, y in zip(ox, oy))
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    # the fixed-size queue makes no burst notification: nothing charged
    assert sim.sim_time_s == 0.0
    assert sim.n_exchanges == (len(ops) * (K + 1) if pipelined
                               else len(ops) * 2 * K)


def test_runtime_contract_on_one_process():
    rt = LocalRuntime(6, device="cpu")
    assert rt.process_role == ProcessRole(0, 1, True)
    assert not rt.multi_process
    shards = rt.pool()[:4]
    assert rt.local_shards(shards) == shards
    x = torch.arange(8).view(4, 2)
    assert rt.gather(x, shards) is x and rt.n_gathers == 1
    assert rt.collective_latency("all_to_all", 1 << 20) == 0.0
    rt.maybe_fail(3)                           # a no-op off SimRuntime
    rt.mark_failed(2)
    assert rt.failed_ids == frozenset({2}) and rt.pool_size == 5
    snap = rt.snapshot()
    assert snap["kind"] == "local" and snap["failed_ids"] == [2]
    assert (snap["process_index"], snap["process_count"]) == (0, 1)
    assert rt.host_reduce(torch.tensor([3, 0])).tolist() == [3, 0]
    assert rt.host_reduce(torch.tensor([True, False]), "any").tolist() \
        == [True, False]


def test_sim_scheduled_failure_drives_leave():
    sim = SimRuntime(4, fail_at={1: 2}, device="cpu")
    q = ElasticDeviceQueue(4, cap=64, payload_width=2, ops_per_shard=4,
                           runtime=sim)

    def step_fn(state, step):
        n = q.n_shards * q.L
        q.step(np.zeros(n, bool), np.zeros(n, bool),
               np.zeros((n, 2), np.int32))
        return state

    with tempfile.TemporaryDirectory() as d:
        _, metrics = run_with_restarts(
            init_state=lambda: {}, step_fn=step_fn, n_steps=4, ckpt_dir=d,
            ckpt_every=100, injector=sim, elastic=elastic_queue_policy(q),
            log=lambda *a: None)
    assert metrics["leaves"] == 1 and metrics["restarts"] == 0, metrics
    assert 2 not in q.device_ids and 2 in sim.failed_ids
    sim.maybe_fail(1)                          # fires once per step only


@pytest.mark.parametrize("use_sim", [False, True])
def test_leave_regrow_never_resurrects_dead_shard(use_sim):
    """The reference's ``test_leave_regrow_never_resurrects_dead_device``:
    a failure keyed by stable id LEAVEs, the regrow JOIN draws another
    shard, the dead one stays out of later growth, and the FIFO stream is
    intact.  With ``use_sim`` the SimRuntime is the injector."""
    dead = 3
    if use_sim:
        rt = SimRuntime(8, fail_at={2: dead}, device="cpu")
        inj = rt
    else:
        rt = LocalRuntime(8, device="cpu")
        inj = FailureInjector(device_fail_at={2: dead})
    q = ElasticDeviceQueue(4, cap=64, payload_width=2, ops_per_shard=4,
                           runtime=rt)
    got = []

    def step_fn(state, step):
        n = q.n_shards * q.L
        e = np.zeros(n, bool)
        v = np.zeros(n, bool)
        pw = np.zeros((n, 2), np.int32)
        e[:4] = v[:4] = True
        pw[:4, 0] = np.arange(step * 4, step * 4 + 4)
        v[4:6] = True
        _, _, dv, dok, _ = q.step(e, v, pw)
        got.extend(dv.numpy()[dok.numpy()][:, 0].tolist())
        return {"done": np.int64(step + 1)}

    with tempfile.TemporaryDirectory() as d:
        _, metrics = run_with_restarts(
            init_state=lambda: {"done": np.int64(0)}, step_fn=step_fn,
            n_steps=8, ckpt_dir=d, ckpt_every=100, injector=inj,
            elastic=elastic_queue_policy(q, regrow_after=2),
            log=lambda *a: None)
    assert metrics["leaves"] == 1 and metrics["joins"] == 1, metrics
    assert metrics["restarts"] == 0 and metrics["steps_run"] == 8
    assert q.n_shards == 4 and dead not in q.device_ids
    assert dead in rt.failed_ids
    q.grow(2)
    q.shrink([4, 5])
    assert dead not in q.device_ids
    q.grow(3)                                   # the whole live pool
    assert dead not in q.device_ids and q.n_shards == 7
    while q.size > 0:
        n = q.n_shards * q.L
        _, _, dv, dok, _ = q.step(np.zeros(n, bool), np.ones(n, bool),
                                  np.zeros((n, 2), np.int32))
        got.extend(dv.numpy()[dok.numpy()][:, 0].tolist())
    assert got == list(range(32)), got


def test_unknown_runtime_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceQueue(2, runtime=object())
    with pytest.raises(ValueError, match="pool_size"):
        ElasticDeviceQueue(2, pool_size=4, runtime=LocalRuntime(4,
                                                                device="cpu"))


def _exchange_case(case: str, rt):
    """Drive ``case`` on a 4-shard elastic FIFO queue over ``rt``; returns
    (bytes counted, bytes of the closed form)."""
    n, L_, W_, K_, cap = 4, 4, 2, 3, 16
    rng = np.random.default_rng(7)
    q = ElasticDeviceQueue(n, cap=cap, payload_width=W_, ops_per_shard=L_,
                           pipelined=case != "sequential", runtime=rt)
    nL = n * L_
    E, V = rng.random((K_, nL)) < 0.7, rng.random((K_, nL)) < 0.9
    P = rng.integers(0, 1 << 20, (K_, nL, W_)).astype(np.int32)
    q.run_waves(E, V, P)                 # a backlog for the migration
    b0 = rt.exchange_bytes
    # request slot ‖ tag ‖ payload, reply ok ‖ value: int32 columns of
    # [n_src, n_dst, L] buffers
    req, rep = 4 * (2 + W_) * n * n * L_, 4 * (1 + W_) * n * n * L_
    if case == "step":
        q.step(E[0], V[0], P[0])
        want = req + rep
    elif case == "pipelined":
        q.run_waves(E, V, P)
        want = K_ * (req + rep) + rep
    elif case == "sequential":
        q.run_waves(E, V, P)
        want = K_ * (req + rep)
    else:                                # one LEAVE 4 -> 3
        q.shrink([3])
        M = fanout_bound(4, 3, cap)
        want = 4 * 3 * M * 4 * (1 + W_)  # [n_old, n_new, M, slot ‖ value]
    return rt.exchange_bytes - b0, want


@pytest.mark.parametrize("case", ["step", "pipelined", "sequential",
                                  "migration"])
@pytest.mark.parametrize("kind", ["local", "sim"])
def test_exchange_bytes_match_the_closed_form(kind, case):
    rt = (LocalRuntime(4, device="cpu") if kind == "local"
          else SimRuntime(4, LatencyModel(base_us=5.0), device="cpu"))
    got, want = _exchange_case(case, rt)
    assert got == want
    assert rt.snapshot()["exchange_bytes"] == rt.exchange_bytes > 0


def test_burst_span_records_exchange_bytes_and_ops():
    from repro_torch.obs import tracer
    rt = LocalRuntime(4, device="cpu")
    n0 = len(tracer.events())
    got, want = _exchange_case("pipelined", rt)
    bursts = [e for e in tracer.events()[n0:] if e["name"] == "queue:burst"]
    assert bursts[-1]["args"]["exchange_bytes"] == got == want
    assert bursts[-1]["args"]["ops"] == 3 * 4 * 4
