"""ServeEngine in two processes under gloo, against one process.

``launch_localhost`` starts two CPU processes, each holding 4 of the 8
shards of a ``DistributedRuntime``.  In each, ``ServeEngine`` runs its
FIFO, tier (3 tiers, ``relaxation=1``) and EDF (deferral and the
autoscaler) modes on ``mamba2_130m`` cut to 2 layers, its parameters
drawn from the same seed in every process: every process submits the
same requests and decodes on its own replica of the model, while the
request queue's shards are split over the two processes.  The FIFO and
tier scenarios resize the queue 8 -> 6 -> 8 between bursts; the EDF one
starts on 6 shards, and the autoscaler grows it to the pool's 8 and
shrinks it back to 5 (never fewer, so both processes keep a shard).

Both processes must serve the same requests at the same steps with the
same tokens, admission outcome, tier and deadline statistics and
``metrics()`` (the admission policy's timing fields left out), and equal
to the same scenario on one process's ``LocalRuntime(8)``; the one-process
engine is held against the JAX package's in ``test_torch_serve_modes.py``.
"""
import json

import pytest

from repro_torch.runtime import LocalRuntime, launch_localhost

SCENARIOS = ("fifo", "tiers", "edf")

SCEN = r"""
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import (AdmissionRejected, ControllerConfig,
                               HysteresisController, Request, ServeEngine)

SLOTS, MAX_SEQ = 3, 24


def build():
    model = build_model(get_config("mamba2_130m").reduced(n_layers=2))
    return model, model.init_params(0, device="cpu")


def req(rid, n_prompt=3, max_new=3, **kw):
    return Request(rid=rid, prompt=[(rid * 7 + t) % 97 + 1
                                    for t in range(n_prompt)],
                   max_new=max_new, **kw)


def metrics(eng):
    m = eng.metrics()
    ac = m.get("admission_control")
    if ac is not None:
        m["admission_control"] = {k: v for k, v in ac.items()
                                  if not k.startswith("decide_us")}
    return m


def fifo(eng):
    reqs = [req(i) for i in range(7)]
    eng.submit(reqs)
    for _ in range(3):
        eng.step()
    resizes = [eng.resize(6)["moved"]]
    more = [req(10 + i) for i in range(5)]
    eng.submit(more)
    eng.step()
    resizes.append(eng.resize(8)["moved"])
    assert eng.run_until_drained(max_steps=300)
    return reqs + more, {"moved": resizes}


def tiers(eng):
    reqs = [req(i, 2, 2, prio=i % 3) for i in range(9)]
    eng.submit(reqs[:6])
    eng.step()
    moved = [eng.resize(6)["moved"]]
    eng.submit(reqs[6:])
    eng.step()
    moved.append(eng.resize(8)["moved"])
    assert eng.run_until_drained(max_steps=300)
    return reqs, {"moved": moved, "tiers": eng.tier_wait_stats()}


def edf(eng):
    loose = [req(i, 3, 3, deadline=40 + i) for i in range(12)]
    sheds = []
    try:
        eng.submit(loose)
    except AdmissionRejected as err:
        sheds.append([err.kind, [r.rid for r in err.shed]])
    shards = []
    for _ in range(4):
        eng.step()
        shards.append(eng.queue.n_shards)
    tight = [req(20 + i) for i in range(4)]
    try:
        eng.submit(tight, deadline=2)
    except AdmissionRejected as err:
        sheds.append([err.kind, [r.rid for r in err.shed]])
    for _ in range(300):
        if eng.run_until_drained(max_steps=1):
            break
        shards.append(eng.queue.n_shards)
    for _ in range(12):                       # idle: the shrinks
        eng.step()
        shards.append(eng.queue.n_shards)
    snap = eng.autoscale.snapshot()
    assert snap["grows"] >= 1 and snap["shrinks"] >= 1, snap
    return [r for r in loose + tight if r.done], {
        "sheds": sheds, "shards": shards, "autoscale": snap,
        "deadline": eng.deadline_stats(), "dir": eng.queue.directory()}


def serve(name, model, params, rt):
    kw = {"fifo": dict(queue_cap=4),
          "tiers": dict(priorities=3, relaxation=1, queue_cap=4),
          "edf": dict(deadline=True, admission="defer", queue_cap=1,
                      spill_cap=16, n_buckets=4, deadline_horizon=16,
                      autoscale=HysteresisController(ControllerConfig(
                          high_watermark=0.5, low_watermark=0.2,
                          high_patience=1, low_patience=3, cooldown=1,
                          min_shards=5)))}[name]
    eng = ServeEngine(model, params, 6 if name == "edf" else 8,
                      max_slots=SLOTS, max_seq=MAX_SEQ, runtime=rt, **kw)
    reqs, extra = {"fifo": fifo, "tiers": tiers, "edf": edf}[name](eng)
    return {"reqs": [[r.rid, r.prio, r.deadline, r.start_step,
                      r.finish_step, r.out] for r in reqs],
            "extra": extra, "metrics": metrics(eng),
            "ids": [s.id for s in eng.queue.shards]}
"""

CHILD = r"""
import json
from repro_torch.runtime import DistributedRuntime
rt = DistributedRuntime.from_env(device="cpu")
model, params = build()
result = {name: serve(name, model, params, rt)
          for name in ("fifo", "tiers", "edf")}
rt.close()
print("RESULT" + json.dumps(result))
"""


def _json(x):
    """Round-trip through JSON, as the children's results come back."""
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def two_process():
    res = launch_localhost(code=SCEN + CHILD, n_procs=2,
                           shards_per_process=4, timeout=400)
    out = []
    for r in res:
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")]
        assert line, r.stderr
        out.append(json.loads(line[0][len("RESULT"):]))
    return out


@pytest.fixture(scope="module")
def one_process():
    ns = {}
    exec(SCEN, ns)
    model, params = ns["build"]()
    return {name: _json(ns["serve"](name, model, params,
                                    LocalRuntime(8, device="cpu")))
            for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_serving_in_two_processes_equals_one_process(two_process,
                                                     one_process, name):
    want = one_process[name]
    assert two_process[0][name] == two_process[1][name] == want
    assert all(len(r[5]) > 0 for r in want["reqs"])
    assert want["ids"] == list(range(len(want["ids"])))


def test_scenarios_exercise_the_modes(one_process):
    """Each scenario really resized, tiered, deferred and autoscaled."""
    fifo, tiers, edf = (one_process[n] for n in SCENARIOS)
    assert fifo["extra"]["moved"][0] > 0 and len(fifo["reqs"]) == 12
    assert tiers["metrics"]["queue"]["kind"] == "pqueue"
    assert tiers["metrics"]["queue"]["migrations"] == 2
    assert edf["metrics"]["admission_control"]["deferred"] > 0
    assert max(edf["extra"]["shards"]) == 8
    assert min(edf["extra"]["shards"]) == 5
    assert edf["extra"]["deadline"]["n"] == len(edf["reqs"])
