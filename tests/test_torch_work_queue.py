"""The port's WorkQueue against the JAX package's.

The reference's schedule tests (a pre-burst lease retried at the wave
where a per-step loop retries it; a burst longer than the lease horizon
cut into the per-step schedule), its overflow case and its straggler run,
here on ``device="cpu"``.  Then a seeded differential: the same scenario
(stragglers, grants never acked, duplicate acks, bursts longer than
``lease_steps + 1``) runs the JAX ``WorkQueue`` on a forced 4-device mesh
in one subprocess and the port's on a LocalRuntime and on a SimRuntime;
the grants of every wave, ``stats``, the lease dict (order included) and
``step_no`` must be identical.
"""
import json

import numpy as np
import pytest

from multidev import run_multidev

from repro_torch.dqueue import DeviceQueue, QueueOverflowError, WorkQueue
from repro_torch.runtime import LatencyModel, SimRuntime


def _wq(n_shards=1, cap=32, L=8, lease_steps=3, **kw):
    return WorkQueue(DeviceQueue(n_shards, cap=cap, payload_width=4,
                                 ops_per_shard=L, device="cpu", **kw),
                     lease_steps=lease_steps)


def test_work_queue_burst_expiry_matches_per_step():
    wq = _wq(lease_steps=3)
    item = wq.make_item([7])
    grants = wq.step([item], [1])          # step 1: granted, never acked
    assert len(grants) == 1
    # steps 2-5 as one burst: the lease (issued step 1) expires at step 5
    bursts = wq.run_waves([[], [], [], []], [[1]] * 4)
    assert [len(g) for g in bursts] == [0, 0, 0, 1]
    assert int(bursts[3][0][1][0]) == int(item[0])
    assert wq.stats["reissued"] == 1


@pytest.mark.parametrize("pipelined", [True, False])
def test_work_queue_oversized_burst_chunks_to_per_step_schedule(pipelined):
    K = 8  # >> lease_steps + 1 = 3
    wq_burst = _wq(lease_steps=2, pipelined=pipelined)
    wq_step = _wq(lease_steps=2, pipelined=pipelined)
    submits = [[wq_burst.make_item([5])]] + [[] for _ in range(K - 1)]
    submits_ref = [[wq_step.make_item([5])]] + [[] for _ in range(K - 1)]
    wants = [[1]] * K
    x0 = wq_burst.dq.runtime.n_exchanges
    grants_burst = wq_burst.run_waves(submits, wants)
    # three sub-bursts of at most 3 waves: 4 + 4 + 3 exchanges pipelined
    assert wq_burst.dq.runtime.n_exchanges - x0 == (
        11 if pipelined else 2 * K)
    grants_step = [wq_step.step(s, w) for s, w in zip(submits_ref, wants)]
    flat = [[(w, int(item[0])) for w, item in g] for g in grants_burst]
    flat_ref = [[(w, int(item[0])) for w, item in g] for g in grants_step]
    assert flat == flat_ref
    assert sum(len(g) for g in grants_burst) >= 2
    assert wq_burst.stats["reissued"] == wq_step.stats["reissued"] >= 1


def test_overflow_raises_in_work_queue():
    wq = _wq(cap=2, L=4, lease_steps=8)
    wq.step([wq.make_item([7]) for _ in range(2)], [0])   # exactly full
    with pytest.raises(QueueOverflowError) as ei:
        wq.step([wq.make_item([8])], [1])                 # wrap-around
    assert ei.value.kind == "workqueue" and "leases" in str(ei.value)


def test_oversized_wave_raises_work_error():
    wq = _wq(L=4)
    with pytest.raises(QueueOverflowError) as ei:
        wq.step([wq.make_item([1]) for _ in range(3)], [1, 1])
    assert ei.value.kind == "work" and ei.value.occupancy == [5]
    with pytest.raises(ValueError):
        wq.run_waves([[]], [])


def test_work_queue_straggler_mitigation_4_shards():
    wq = _wq(n_shards=4, cap=128, L=8, lease_steps=3)
    items = [wq.make_item([i, i * i]) for i in range(20)]
    done, pending, straggler_holds, step = set(), list(items), {}, 0
    while len(done) < 20 and step < 60:
        step += 1
        submit, pending = pending[:5], pending[5:]
        for w, item in wq.step(submit, want=[2, 2, 2]):
            eid = int(item[0])
            if w == 2 and eid not in straggler_holds:
                straggler_holds[eid] = step   # worker 2 stalls once
                continue
            if wq.ack(item):
                done.add(eid)
    assert len(done) == 20, (len(done), wq.stats)
    assert wq.stats["reissued"] >= 1


# the scenario both packages run: it reads only the grants, which must agree
SCENARIO = r"""
def drive(wq, seed, n_bursts=14, n_workers=3):
    rng = np.random.default_rng(seed)
    log, held = [], []
    for _ in range(n_bursts):
        K = int(rng.integers(1, 12))     # some bursts > lease_steps + 1
        submits, wants = [], []
        for _k in range(K):
            m = int(rng.integers(0, 6))
            submits.append([wq.make_item([int(x) for x in
                                          rng.integers(0, 1000, 2)])
                            for _ in range(m)])
            wants.append([int(x) for x in rng.integers(0, 3, n_workers)])
        for g in wq.run_waves(submits, wants):
            log.append([[w, [int(v) for v in item]] for w, item in g])
            for w, item in g:
                u = rng.random()
                if u < 0.1:
                    continue                 # never acked
                due = wq.step_no + int(rng.integers(0, 8))  # stragglers
                held.append((due, item.copy()))
                if u > 0.9:                  # acked twice
                    held.append((due + 1, item.copy()))
        due = [h for h in held if h[0] <= wq.step_no]
        held = [h for h in held if h[0] > wq.step_no]
        for _, item in due:
            wq.ack(item)
    leases = [[int(eid), int(l.issued_step), int(l.worker),
               [int(v) for v in l.item]] for eid, l in wq.leases.items()]
    return {"grants": log, "stats": dict(wq.stats), "leases": leases,
            "step_no": wq.step_no, "outstanding": wq.outstanding}
"""
SEEDS = (0, 1)

# the smallest input that leaves a lease on a completed id for good
QUIRK = r"""
def quirk(wq):
    item = wq.make_item([1])
    out = [len(wq.step([item], [1]))]           # step 1: granted
    wq.step([], [0])
    wq.step([], [0])                            # step 3: expired, retried
    out.append(wq.stats["reissued"])
    out.append(bool(wq.ack(item)))              # the first holder, late
    (w, again), = wq.step([], [1])              # step 4: granted again
    out.append(bool(wq.ack(again)))             # a duplicate ack
    wq.step([], [0])
    wq.step([], [0])
    out.append(wq.outstanding)                  # the lease stays
    return out
"""

JAX_SCRIPT = r"""
import json
import numpy as np
from repro.compat import make_mesh
from repro.dqueue import DeviceQueue, WorkQueue
out = {}
for seed in SEEDS:
    mesh = make_mesh((4,), ("data",))
    wq = WorkQueue(DeviceQueue(mesh, "data", cap=128, payload_width=4,
                               ops_per_shard=16), lease_steps=3)
    out[seed] = drive(wq, seed)
mesh = make_mesh((1,), ("data",))
out["quirk"] = quirk(WorkQueue(DeviceQueue(mesh, "data", cap=32,
                                           payload_width=4, ops_per_shard=8),
                               lease_steps=1))
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_runs():
    script = (f"SEEDS = {SEEDS!r}\nimport numpy as np\n" + SCENARIO + QUIRK
              + JAX_SCRIPT)
    out = run_multidev(script, n_dev=4, timeout=300)
    line = [x for x in out.splitlines() if x.startswith("RESULT")][0]
    return {(int(k) if k.isdigit() else k): v
            for k, v in json.loads(line[len("RESULT"):]).items()}


def test_regrant_after_a_late_ack_keeps_its_lease(jax_runs):
    """A reference quirk kept for parity: the expiry scan skips a lease
    on a completed id and a duplicate ack does not remove it, so the
    lease of a re-grant whose first holder acked late stays for good."""
    ns = {}
    exec(QUIRK, ns)
    got = ns["quirk"](_wq(lease_steps=1))
    assert got == jax_runs["quirk"] == [1, 1, True, False, 1]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("runtime", ["local", "sim"])
def test_work_queue_matches_jax(jax_runs, seed, runtime):
    ns = {"np": np}
    exec(SCENARIO, ns)
    rt = (SimRuntime(4, LatencyModel(base_us=25.0, per_mib_us=80.0),
                     device="cpu") if runtime == "sim" else None)
    dq = DeviceQueue(4, cap=128, payload_width=4, ops_per_shard=16,
                     runtime=rt, device=None if rt else "cpu")
    got = json.loads(json.dumps(ns["drive"](WorkQueue(dq, lease_steps=3),
                                            seed)))
    want = jax_runs[seed]
    assert got["step_no"] == want["step_no"]
    assert len(got["grants"]) == len(want["grants"])
    for k, (g, w) in enumerate(zip(got["grants"], want["grants"])):
        assert g == w, f"wave {k}"
    assert got["stats"] == want["stats"]
    assert got["leases"] == want["leases"]
    assert got["outstanding"] == want["outstanding"]
    s = got["stats"]
    assert s["reissued"] > 0 and s["duplicate_acks"] > 0 \
        and s["items_done"] > 0
