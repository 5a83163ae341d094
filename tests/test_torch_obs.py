"""Wavescope in the port against the JAX package.

The drained metrics rows (``drain_metrics`` / the flight recorder's
trajectory) of every structure must equal the reference's on the same
waves: the elastic FIFO queue, LIFO stack, priority queue (strict and
relaxation 1) and Seap queue, each with pipelined and sequential bursts,
through a grow (4 -> 6 shards) and a shrink (6 -> 4), and a fixed-size
queue whose 4-row ring wraps and is drained with and without a reset.
The JAX side runs in one forced-multi-device subprocess that writes the
rows as JSON; the port runs the same numpy waves on ``device="cpu"``.
Rows are integers: they must be equal.  Also: telemetry adds no
exchange (2 a step, K+1 a pipelined burst, with the ring on or off) and
leaves every queue output unchanged; the tracer's bound, its Chrome
export and the timers; ``to_json``/``to_prometheus`` against the
reference's emitters; the CLI with ``--device cpu``; and a
``ServeEngine(telemetry=True)`` snapshot, ``"waves"`` section included,
equal to the JAX engine's on the same parameters (FIFO, and three tiers
with relaxation 1; neither engine has an admission policy, so the
snapshot holds no timing).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from multidev import run_multidev
from repro.configs import get_config as j_get_config
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as j_build_model
from repro.obs import export as j_export
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.dqueue import (DevicePriorityQueue, DeviceQueue,
                                ElasticDevicePriorityQueue,
                                ElasticDeviceQueue, ElasticDeviceSeapQueue,
                                ElasticDeviceStack)
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.obs import (FlightRecorder, METRIC_HEAD, Timers, Tracer,
                             to_json, to_prometheus)
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
CAP, W, L, K = 32, 2, 4, 3
PLAN = [("burst",), ("grow", 2), ("burst",), ("shrink", [0, 3]),
        ("burst",)]
KINDS = ("queue", "stack", "pq0", "pq1", "seap")
SCHEDULES = ("pipe", "seq")


def _shards_per_burst():
    n, out = 4, []
    for step in PLAN:
        if step[0] == "grow":
            n += step[1]
        elif step[0] == "shrink":
            n -= len(step[1])
        else:
            out.append(n)
    return out


def _bursts(kind, seed):
    """One (is_enq, valid, key, payload) per burst of PLAN; the stack's
    waves are all pushes or all pops (interleaved ones would overflow its
    slot depth), Seap keys are spread so that its directory splits."""
    rng = np.random.default_rng(seed)
    out = []
    for b, n in enumerate(_shards_per_burst()):
        nL = n * L
        if kind == "stack":
            E = np.repeat(np.array([True, True, False])[:, None], nL, 1)
        else:
            E = rng.random((K, nL)) < 0.6
        V = rng.random((K, nL)) < 0.9
        key = (rng.integers(-100, 100, (K, nL)) if kind == "seap"
               else rng.integers(0, 3, (K, nL))).astype(np.int32)
        PW = rng.integers(0, 1 << 20, (K, nL, W)).astype(np.int32)
        out.append((E, V, key, PW))
    return out


JAX_SCRIPT = r"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dqueue import (DeviceQueue, ElasticDevicePriorityQueue,
                          ElasticDeviceQueue, ElasticDeviceSeapQueue,
                          ElasticDeviceStack)
d = np.load(IN, allow_pickle=False)
out = {}
def make(kind, pipelined):
    kw = dict(cap=CAP, payload_width=W, ops_per_shard=L, metrics=True,
              flight_k=64, pipelined=pipelined)
    if kind == "queue":
        return ElasticDeviceQueue(4, **kw)
    if kind == "stack":
        return ElasticDeviceStack(4, slot_depth=4, **kw)
    if kind in ("pq0", "pq1"):
        return ElasticDevicePriorityQueue(4, n_prios=3,
                                          relaxation=int(kind[2]), **kw)
    return ElasticDeviceSeapQueue(4, n_buckets=4, split_occupancy=6, **kw)
for kind in KINDS:
    for sched in SCHEDULES:
        eq = make(kind, sched == "pipe")
        b = 0
        for step in PLAN:
            if step[0] == "grow":
                eq.grow(step[1])
            elif step[0] == "shrink":
                eq.shrink(step[1])
            else:
                E, V, KY, PW = (jnp.asarray(d[f"{kind}_{c}{b}"])
                                for c in "EVKP")
                args = (E, V, PW) if kind in ("queue", "stack") else (
                    E, V, KY, PW)
                eq.run_waves(*args)
                b += 1
        out[f"{kind}_{sched}"] = eq.trajectory()
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
q = DeviceQueue(mesh, "data", cap=CAP, payload_width=W, ops_per_shard=L,
                metrics=True, metrics_ring=4)
st = q.init_state()
E, V, _, PW = (jnp.asarray(d[f"queue_{c}0"]) for c in "EVKP")
for k in range(3):
    st, *_ = q.step(st, E[k], V[k], PW[k])
for k in range(3):
    st, *_ = q.step(st, E[k], ~V[k], PW[k])
out["ring_a"] = q.drain_metrics()
out["ring_b"] = q.drain_metrics(reset=True)
st, *_ = q.run_waves(st, E, V, PW)
out["ring_c"] = q.drain_metrics()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    arrays = {}
    for kind in KINDS:
        for b, bt in enumerate(_bursts(kind, seed=KINDS.index(kind))):
            arrays.update({f"{kind}_{c}{b}": x for c, x in zip("EVKP", bt)})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nCAP, W, L = {CAP}, {W}, {L}\n"
              f"PLAN = {PLAN!r}\nKINDS = {KINDS!r}\n"
              f"SCHEDULES = {SCHEDULES!r}\n" + JAX_SCRIPT)
    out = run_multidev(script, n_dev=8, timeout=900)
    return json.loads(out.strip().splitlines()[-1])


def _make(kind, pipelined, metrics=True):
    kw = dict(cap=CAP, payload_width=W, ops_per_shard=L, metrics=metrics,
              flight_k=64, pipelined=pipelined, pool_size=8, device="cpu")
    if kind == "queue":
        return ElasticDeviceQueue(4, **kw)
    if kind == "stack":
        return ElasticDeviceStack(4, slot_depth=4, **kw)
    if kind in ("pq0", "pq1"):
        return ElasticDevicePriorityQueue(4, n_prios=3,
                                          relaxation=int(kind[2]), **kw)
    return ElasticDeviceSeapQueue(4, n_buckets=4, split_occupancy=6, **kw)


def _drive(kind, pipelined, metrics=True):
    """Run PLAN on the port; returns (queue, outputs of every burst,
    exchanges of every burst)."""
    eq = _make(kind, pipelined, metrics)
    bursts = _bursts(kind, seed=KINDS.index(kind))
    outs, exch, b = [], [], 0
    for step in PLAN:
        if step[0] == "grow":
            eq.grow(step[1])
        elif step[0] == "shrink":
            eq.shrink(step[1])
        else:
            E, V, KY, PW = (torch.from_numpy(x) for x in bursts[b])
            args = (E, V, PW) if kind in ("queue", "stack") else (E, V, KY,
                                                                 PW)
            x0 = eq.runtime.n_exchanges
            outs.append([o.clone() for o in eq.run_waves(*args)])
            exch.append(eq.runtime.n_exchanges - x0)
            b += 1
    return eq, outs, exch


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_drained_rows_match_jax(jax_rows, kind, sched):
    eq, _, _ = _drive(kind, sched == "pipe")
    rows = eq.trajectory()
    assert len(rows) == K * len(_shards_per_burst())
    assert rows == jax_rows[f"{kind}_{sched}"]
    assert set(rows[0]) == set(METRIC_HEAD) | {"occ"}
    widths = {r["width"] for r in rows}
    assert widths == {L}
    assert all(r["valid"] == r["puts"] + r["gets"] + r["bottom"]
               for r in rows)


@pytest.mark.parametrize("kind", KINDS)
def test_telemetry_adds_no_exchange_and_changes_no_output(kind):
    on, outs_on, ex_on = _drive(kind, True, metrics=True)
    off, outs_off, ex_off = _drive(kind, True, metrics=False)
    assert ex_on == ex_off == [K + 1] * len(ex_on)
    for a, b in zip(outs_on, outs_off):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert off.trajectory() == []


def test_ring_wraps_and_reset_keeps_the_sequence(jax_rows):
    q = DeviceQueue(4, cap=CAP, payload_width=W, ops_per_shard=L,
                    metrics=True, metrics_ring=4, device="cpu")
    st = q.init_state()
    E, V, _, PW = (torch.from_numpy(x) for x in
                   _bursts("queue", seed=KINDS.index("queue"))[0])
    for k in range(3):
        st, *_ = q.step(st, E[k], V[k], PW[k])
    for k in range(3):
        st, *_ = q.step(st, E[k], ~V[k], PW[k])
    a = q.drain_metrics()
    b = q.drain_metrics(reset=True)
    st, *_ = q.run_waves(st, E, V, PW)
    c = q.drain_metrics()
    assert [r["seq"] for r in a] == [2, 3, 4, 5] and a == b
    assert [r["seq"] for r in c] == [6, 7, 8]
    assert (a, b, c) == (jax_rows["ring_a"], jax_rows["ring_b"],
                         jax_rows["ring_c"])
    assert int(q.engine._mstate.count) == 3
    assert q.engine._mstate.count.dim() == 0


def test_metrics_need_the_fused_path():
    with pytest.raises(ValueError, match="fused"):
        DeviceQueue(2, fused=False, metrics=True, device="cpu")
    # the elastic wrapper keeps the reference's rule: no ring on the seed
    # path, and nothing to drain
    eq = ElasticDeviceQueue(2, fused=False, metrics=True, cap=8,
                            ops_per_shard=2, payload_width=1, device="cpu")
    eq.step(torch.ones(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool),
            torch.zeros((4, 1), dtype=torch.int32))
    assert eq.trajectory() == []


def test_overflow_error_carries_the_trajectory():
    from repro_torch.dqueue import QueueOverflowError
    eq = ElasticDeviceQueue(2, cap=2, payload_width=1, ops_per_shard=2,
                            metrics=True, device="cpu")
    one = torch.ones(4, dtype=torch.bool)
    eq.step(one, one, torch.zeros((4, 1), dtype=torch.int32))
    with pytest.raises(QueueOverflowError) as err:
        eq.step(one, one, torch.zeros((4, 1), dtype=torch.int32))
    traj = err.value.trajectory
    assert [r["seq"] for r in traj] == [0, 1]
    assert [r["occ"] for r in traj] == [[4], [8]]
    assert traj[-1]["headroom"] == 4 - 8


def test_priority_rows_carry_n_relaxed():
    q = DevicePriorityQueue(4, n_prios=3, cap=CAP, payload_width=W,
                            ops_per_shard=L, relaxation=1, metrics=True,
                            device="cpu")
    E, V, KY, PW = (torch.from_numpy(x) for x in
                    _bursts("pq1", seed=KINDS.index("pq1"))[0])
    st, *outs = q.run_waves(q.init_state(), E, V, KY, PW)
    rows = q.drain_metrics()
    assert [r["aux"] for r in rows] == outs[-1].tolist()
    assert [r["occ"] for r in rows][-1] == (st.lasts - st.firsts + 1).tolist()


# ------------------------------------------------------------ host side ---
def test_tracer_is_bounded_and_exports_chrome_trace(tmp_path):
    tr = Tracer(max_events=3)
    for i in range(5):
        with tr.span(f"s{i}", cat="test", i=i, shape=(2, 3)):
            with tr.span("inner"):
                pass
    ev = tr.events()
    assert len(ev) == 3 and ev[-1]["name"] == "s4"
    assert ev[-1]["args"] == {"i": 4, "shape": "(2, 3)"}
    path = tr.export_chrome_trace(tmp_path / "t.json")
    doc = json.loads(Path(path).read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert [e["ph"] for e in doc["traceEvents"]] == ["X"] * 3
    assert all(e["dur"] >= 0 for e in doc["traceEvents"])
    tr.clear()
    assert tr.events() == []


def test_spans_show_in_the_torch_profiler():
    tr = Tracer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("burst", cat="wave"):
            torch.ones(3).sum()
    assert "wave:burst" in {e.key for e in prof.key_averages()}


def test_timers():
    t = Timers()
    for _ in range(3):
        with t("wave"):
            pass
    t("mig").start(sync_fn=lambda: None).stop(sync_fn=lambda: None)
    assert t("wave").count == 3 and "mig" in t and t.names() == ["mig",
                                                                 "wave"]
    assert t("wave").elapsed("max") >= t("wave").elapsed("min") >= 0
    assert t("wave").elapsed("sum") == pytest.approx(
        3 * t("wave").elapsed("mean"))
    rep = t.report()
    assert rep["wave"]["n"] == 3 and set(rep["mig"]) == {"n", "sum_s",
                                                        "mean_s"}
    with pytest.raises(ValueError):
        t("wave").elapsed("median")
    with pytest.raises(RuntimeError):
        t("never").stop()
    t("wave").reset()
    assert t("wave").elapsed() == 0.0


def test_exporters_match_the_reference():
    snap = {"step": 3, "queue": {"occupancy": [4, 0, 2], "kind": "pqueue",
                                 "ok": True},
            "tiers": {0: {"n": 2, "p99": 1.5}, 1: {"n": 0}},
            "waves": [{"seq": 0, "occ": [1, 2]}], "name-x": 1.25}
    assert to_json(snap) == j_export.to_json(snap)
    assert to_prometheus(snap) == j_export.to_prometheus(snap)
    assert to_prometheus(snap, prefix="p") == j_export.to_prometheus(
        snap, prefix="p")
    assert 'repro_tiers_n{index="0"} 2' in to_prometheus(snap)
    assert to_prometheus({}) == ""


def test_flight_recorder_keeps_the_last_k():
    rec = FlightRecorder(2)
    rec.extend([{"seq": i} for i in range(3)])
    assert rec.trajectory() == [{"seq": 1}, {"seq": 2}] and len(rec) == 2
    with pytest.raises(ValueError):
        FlightRecorder(0)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def test_cli_smoke_on_cpu(tmp_path):
    trace = tmp_path / "trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--smoke", "--device",
         "cpu", "--waves", "5", "--json", str(tmp_path / "s.json"),
         "--trace", str(trace)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads((tmp_path / "s.json").read_text())
    assert rep["ok"] and rep["exchanges"]["added"] == 0
    assert [r["seq"] for r in rep["wave_summaries"]] == list(range(5))
    assert "OK" in proc.stderr
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"obs:smoke", "queue:burst"} <= names
    prom = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--device", "cpu",
         "--format", "prom"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert prom.returncode == 0
    assert "repro_obs_exchanges_added 0" in prom.stdout


# ------------------------------------------------------ serving engine ---
SLOTS, MAX_SEQ = 3, 24


@pytest.fixture(scope="module")
def models():
    cfg = j_get_config("mamba2_130m").reduced(n_layers=2)
    jm = j_build_model(cfg)
    jp, _ = jm.init_params(jax.random.key(0))
    tm = build_model(get_config("mamba2_130m").reduced(n_layers=2))
    return cfg, jm, jp, tm, params_from_jax(jp, "cpu")


@pytest.mark.parametrize("kw", [{}, {"priorities": 3, "relaxation": 1}],
                         ids=["fifo", "tiers_relaxed"])
def test_serve_telemetry_snapshot_matches_jax(models, kw):
    cfg, jm, jp, tm, tp = models
    je = JServeEngine(jm, jp, make_host_mesh(n_data=1), max_slots=SLOTS,
                      max_seq=MAX_SEQ, telemetry=True, flight_k=64, **kw)
    te = ServeEngine(tm, tp, 1, max_slots=SLOTS, max_seq=MAX_SEQ,
                     telemetry=True, flight_k=64, device="cpu", **kw)
    for eng, R in ((je, JRequest), (te, Request)):
        rng = np.random.default_rng(0)
        reqs = [R(rid=i, prompt=[int(t) for t in
                                 rng.integers(0, cfg.vocab, 2)],
                  max_new=2, prio=i % 3 if kw else 0) for i in range(6)]
        eng.submit(reqs)
        for _ in range(3):
            eng.step()
    snap = te.metrics()
    assert snap == je.metrics()
    waves = snap["waves"]
    assert waves and [w["seq"] for w in waves] == list(range(len(waves)))
    assert sum(w["puts"] for w in waves) == 6
    assert "repro_waves_puts" in to_prometheus(snap)
    assert to_json(snap) == j_export.to_json(je.metrics())
