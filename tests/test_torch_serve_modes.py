"""The port's ServeEngine modes against the JAX package's engine.

SLA tiers (``priorities=3``, strict and ``relaxation=1``), EDF admission
(``deadline=True``), the three admission policies (shed, defer, degrade;
degrade on a tier engine and on an EDF engine) and the autoscaler with a
grow and a shrink.  Both engines serve the same scenario on
``mamba2_130m.reduced(n_layers=2)`` with the same parameters (crossed bit
for bit by ``params_from_jax``), compared as ``tests/test_torch_serve.py``
compares the FIFO engine (``_compare``): served ids, every start and
finish step, each decode step's slot assignment, and tokens up to the
first step whose JAX top-2 logit margin is under ``MARGIN_TOL``.  Also
compared: ``tier_wait_stats``, ``deadline_stats``, the request ids in each
``AdmissionRejected.shed``, the tiers and deadlines the degrade policy
set, and ``metrics()`` with the policy's timing fields (``decide_us_*``)
left out.  The scenarios on one queue shard run the JAX engine in this
process; the relaxed tiers on two shards and the autoscaler (a pool of
four shards) run it in one subprocess with four forced CPU devices.
"""
import json
import os
import types

import pytest

from multidev import run_multidev
from repro.launch.mesh import make_host_mesh
from repro.serve import AdmissionRejected as JAdmissionRejected
from repro.serve import ControllerConfig as JControllerConfig
from repro.serve import HysteresisController as JHysteresisController
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from test_torch_serve import models  # noqa: F401  (the fixture)
from test_torch_serve import (MAX_SEQ, SLOTS, _compare, _jax_side,
                              _trace_jax, _trace_port)

from repro_torch.serve import (AdmissionRejected, ControllerConfig,
                               HysteresisController, Request, ServeEngine)

JAX_API = types.SimpleNamespace(Request=JRequest,
                                AdmissionRejected=JAdmissionRejected,
                                ControllerConfig=JControllerConfig,
                                HysteresisController=JHysteresisController)
PORT_API = types.SimpleNamespace(Request=Request,
                                 AdmissionRejected=AdmissionRejected,
                                 ControllerConfig=ControllerConfig,
                                 HysteresisController=HysteresisController)


def _metrics(eng) -> dict:
    """``metrics()`` without the admission policy's timing fields."""
    m = eng.metrics()
    ac = m.get("admission_control")
    if ac is not None:
        m["admission_control"] = {k: v for k, v in ac.items()
                                  if not k.startswith("decide_us")}
    return m


def _submit(eng, api, reqs, **kw) -> list:
    """Submit; returns the ids an ``AdmissionRejected`` shed (and its
    kind), or [] when everything was accepted."""
    try:
        eng.submit(reqs, **kw)
    except api.AdmissionRejected as err:
        return [err.kind, [r.rid for r in err.shed]]
    return []


def _req(api, rid, n_prompt=2, max_new=2, **kw):
    return api.Request(rid=rid, prompt=[(rid * 7 + t) % 97 + 1
                                        for t in range(n_prompt)],
                       max_new=max_new, **kw)


# --------------------------------------------------------- scenarios ------
def tiers_scenario(eng, api):
    """Tier 2 first, then tiers 1 and 0 while it waits: tier 0 is admitted
    ahead of everything still queued."""
    low = [_req(api, i, 3, 3, prio=2) for i in range(5)]
    eng.submit(low)
    eng.step()
    mid = [_req(api, 10 + i, prio=1) for i in range(3)]
    high = [_req(api, 20 + i) for i in range(3)]
    eng.submit(mid)
    eng.submit(high, prio=0)
    assert eng.run_until_drained(max_steps=300)
    queued = [r for r in low + mid if r.start_step > 1]
    assert max(r.start_step for r in high) <= min(r.start_step
                                                  for r in queued)
    return low + mid + high, {"tiers": eng.tier_wait_stats()}


def deadline_scenario(eng, api):
    """Loose deadlines first, then tight ones: EDF admits the tight ones
    ahead of the loose ones still queued."""
    loose = [_req(api, i, 3, 3, deadline=40 + i) for i in range(5)]
    eng.submit(loose)
    eng.step()
    tight = [_req(api, 10 + i) for i in range(4)]
    eng.submit(tight, deadline=2)
    assert eng.run_until_drained(max_steps=300)
    queued = [r for r in loose if r.start_step > 1]
    assert max(r.start_step for r in tight) <= min(r.start_step
                                                   for r in queued)
    return loose + tight, {"deadline": eng.deadline_stats(),
                           "dir": eng.queue.directory()}


def shed_scenario(eng, api):
    """A window of 2: the excess is shed and resubmitted until accepted."""
    reqs = [_req(api, i) for i in range(7)]
    sheds, todo = [], reqs
    for _ in range(20):
        if not todo:
            break
        got = _submit(eng, api, todo)
        sheds.append(got)
        shed = set(got[1]) if got else set()
        todo = [r for r in todo if r.rid in shed]
        eng.step()
    assert eng.run_until_drained(max_steps=300)
    assert sum(1 for s in sheds if s) >= 2
    return reqs, {"sheds": sheds}


def defer_scenario(eng, api):
    """A window of 2 and a spill of 2: two staged, two deferred, the rest
    refused as spill overflow; the deferred ones drain ahead of later
    arrivals."""
    first = [_req(api, i) for i in range(6)]
    sheds = [_submit(eng, api, first)]
    assert sheds[0][0] == "spill-overflow"
    eng.step()
    later = [_req(api, 10 + i) for i in range(2)]
    sheds.append(_submit(eng, api, later))
    assert eng.run_until_drained(max_steps=300)
    kept = [r for r in first + later if r.done]
    return kept, {"sheds": sheds, "spill_peak":
                  eng.admission_stats["spill_peak"]}


def degrade_tiers_scenario(eng, api):
    """Tier 0 overflows its window of 2: the excess goes down a tier, then
    two, and the rest is shed."""
    reqs = [_req(api, i) for i in range(7)]
    sheds = [_submit(eng, api, reqs)]
    eng.step()
    assert eng.run_until_drained(max_steps=300)
    kept = [r for r in reqs if r.done]
    return kept, {"sheds": sheds, "prios": [r.prio for r in reqs],
                  "tiers": eng.tier_wait_stats()}


def degrade_edf_scenario(eng, api):
    """An EDF bucket overflows: the excess gets its deadline extended to
    a later bucket with headroom."""
    reqs = [_req(api, i) for i in range(7)]
    sheds = [_submit(eng, api, reqs, deadline=3)]
    eng.step()
    assert eng.run_until_drained(max_steps=300)
    kept = [r for r in reqs if r.done]
    return kept, {"sheds": sheds, "deadlines": [r.deadline for r in reqs],
                  "deadline": eng.deadline_stats()}


def relaxed_scenario(eng, api):
    """Three tiers with relaxation 1 over two queue shards."""
    reqs = [_req(api, i, 2, 2, prio=i % 3) for i in range(9)]
    eng.submit(reqs[:6])
    eng.step()
    eng.submit(reqs[6:])
    assert eng.run_until_drained(max_steps=300)
    return reqs, {"tiers": eng.tier_wait_stats()}


def autoscale_scenario(eng, api):
    """A queue window of 4 on one of four shards, with deferral: a burst
    of 12 keeps the autoscaler above its high watermark until it grows,
    and the idle steps after the drain shrink it back."""
    reqs = [_req(api, i, 3, 3) for i in range(12)]
    sheds = [_submit(eng, api, reqs)]
    shards = []
    for _ in range(300):
        if eng.run_until_drained(max_steps=1):
            break
        shards.append(eng.queue.n_shards)
    for _ in range(12):                       # idle: the shrink
        eng.step()
        shards.append(eng.queue.n_shards)
    snap = eng.autoscale.snapshot()
    assert snap["grows"] >= 1 and snap["shrinks"] >= 1, snap
    return reqs, {"sheds": sheds, "shards": shards, "autoscale": snap}


def _autoscaler(api):
    return api.HysteresisController(api.ControllerConfig(
        high_watermark=0.5, low_watermark=0.2, high_patience=1,
        low_patience=3, cooldown=1))


# name -> (scenario, engine kwargs[, queue shards]); a callable kwarg
# is built for the engine's API by _kwargs
LOCAL = {
    "tiers": (tiers_scenario, {"priorities": 3}),
    "tiers_relaxed_one_shard": (relaxed_scenario,
                                {"priorities": 3, "relaxation": 1}),
    "deadline": (deadline_scenario, {"deadline": True}),
    "shed": (shed_scenario, {"admission": "shed", "queue_cap": 2}),
    "defer": (defer_scenario, {"admission": "defer", "queue_cap": 2,
                               "spill_cap": 2}),
    "degrade_tiers": (degrade_tiers_scenario,
                      {"admission": "degrade", "queue_cap": 2,
                       "priorities": 3}),
    "degrade_edf": (degrade_edf_scenario,
                    {"admission": "degrade", "queue_cap": 2,
                     "deadline": True, "n_buckets": 4,
                     "deadline_horizon": 16}),
}
REMOTE = {
    "tiers_relaxed": (relaxed_scenario, {"priorities": 3, "relaxation": 1},
                      2),
    "autoscale": (autoscale_scenario, {"admission": "defer", "queue_cap": 4,
                                       "autoscale": _autoscaler}, 1),
}


def _kwargs(kw, api):
    return {k: (v(api) if callable(v) else v) for k, v in kw.items()}


def _result(reqs, extra, log, eng):
    return {"reqs": [[r.rid, r.start_step, r.finish_step, r.out]
                     for r in reqs], "extra": extra, "log": log,
            "metrics": _metrics(eng)}


def jax_modes_run() -> dict:
    """The JAX engine's side of the multi-shard scenarios (run in a
    process with four CPU devices)."""
    cfg, jm, jp = _jax_side()
    out = {}
    for name, (scenario, kw, n_shards) in REMOTE.items():
        eng = JServeEngine(jm, jp, make_host_mesh(n_data=n_shards),
                           max_slots=SLOTS, max_seq=MAX_SEQ,
                           **_kwargs(kw, JAX_API))
        log = _trace_jax(eng)
        reqs, extra = scenario(eng, JAX_API)
        out[name] = _result(reqs, extra, log, eng)
    return out


def _json(x):
    """Round-trip through JSON, as the subprocess's results come back
    (tuples become lists, int keys strings)."""
    return json.loads(json.dumps(x))


def _check(j: dict, treqs, textra, tlog, teng):
    jreqs = [JRequest(rid=rid, prompt=[], start_step=s, finish_step=f,
                      out=out) for rid, s, f, out in j["reqs"]]
    _compare(jreqs, treqs, j["log"], tlog)
    assert _json(textra) == _json(j["extra"])
    assert _json(_metrics(teng)) == _json(j["metrics"])


@pytest.mark.parametrize("name", list(LOCAL))
def test_mode_matches_jax(models, name):
    scenario, kw = LOCAL[name]
    cfg, jm, jp, tm, tp = models
    je = JServeEngine(jm, jp, make_host_mesh(n_data=1), max_slots=SLOTS,
                      max_seq=MAX_SEQ, **_kwargs(kw, JAX_API))
    jlog = _trace_jax(je)
    jreqs, jextra = scenario(je, JAX_API)
    te = ServeEngine(tm, tp, 1, max_slots=SLOTS, max_seq=MAX_SEQ,
                     device="cpu", **_kwargs(kw, PORT_API))
    tlog = _trace_port(te)
    treqs, textra = scenario(te, PORT_API)
    _check(_json(_result(jreqs, jextra, jlog, je)), treqs, textra, tlog, te)


@pytest.fixture(scope="module")
def jax_remote():
    here = os.path.dirname(os.path.abspath(__file__))
    out = run_multidev(
        "import json, sys\n"
        f"sys.path.insert(0, {here!r})\n"
        "from test_torch_serve_modes import jax_modes_run\n"
        "print('RESULT ' + json.dumps(jax_modes_run()))\n", n_dev=4)
    return json.loads(out.split("RESULT ", 1)[1])


@pytest.mark.parametrize("name", list(REMOTE))
def test_multi_shard_mode_matches_jax(models, jax_remote, name):
    scenario, kw, n_shards = REMOTE[name]
    te = ServeEngine(models[3], models[4], n_shards, max_slots=SLOTS,
                     max_seq=MAX_SEQ, pool_size=4, device="cpu",
                     **_kwargs(kw, PORT_API))
    tlog = _trace_port(te)
    treqs, textra = scenario(te, PORT_API)
    _check(jax_remote[name], treqs, textra, tlog, te)


def test_exclusive_modes_raise(models):
    with pytest.raises(ValueError, match="exclusive"):
        ServeEngine(models[3], models[4], 1, priorities=2, deadline=True,
                    device="cpu")
    with pytest.raises(ValueError, match="unknown admission policy"):
        ServeEngine(models[3], models[4], 1, admission="drop", device="cpu")
