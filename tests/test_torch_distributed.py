"""Two processes under gloo against one process, and against JAX.

``launch_localhost`` starts two CPU processes, each holding 4 of 8 shards
of a ``DistributedRuntime``.  Each drives an elastic FIFO queue, the same
on the five-exchange seed wave, and an elastic LIFO stack through the
same schedule: bursts, a single step, a
LEAVE of the shards with indices 2-5 (two from each process), then JOINs
of 2 and 2, which leave the active order ``[0, 1, 6, 7, 2, 3, 4, 5]``:
process 0's shards split around process 1's, and the processes uneven in
between (4 and 2).  An exchange or gather that assumed process-contiguous
shards passes every schedule without the regrow and fails this one.

The per-op outputs (gathered by ``to_host``), the migrations' moved
counts and the final store (gathered in active order) must be
bit-identical to the same schedule on one process's LocalRuntime, and
the FIFO run to the JAX package's ``ElasticDeviceQueue`` on a forced
8-device mesh.  The exchange budget holds on both runtimes (K+1 a
pipelined burst, 2 a step, 1 a migration), and the two-process run adds
one gather a wave (the op bits), one a LIFO burst (its overflow flag)
and one a migration (the moved count and lost flag).  The Wavescope
rows each process drains (gathered) equal one process's.  ``WorkQueue``
and ``save``/``restore``, which the reference runs on one process only,
raise ``NotImplementedError`` there, naming the reference's limit.
"""
import json

import numpy as np
import pytest

from multidev import run_multidev

from repro_torch.runtime import LocalRuntime, launch_localhost

# the schedule both runtimes run; ``run`` returns global host arrays
SCHEDULE = r"""
import hashlib
import numpy as np
from repro_torch.dqueue import ElasticDeviceQueue, ElasticDeviceStack

N, CAP, W, L, K, D = 8, 64, 2, 4, 3, 4
PLAN = [("burst", 0.7), ("burst", 0.7), ("step", 0.6),
        ("shrink", [2, 3, 4, 5]), ("burst", 0.5), ("grow", 2),
        ("burst", 0.6), ("grow", 2), ("burst", 0.4), ("burst", 0.0),
        ("burst", 0.0), ("burst", 0.0)]


def make_ops(kind, seed=42):
    # one (E, V, P) per burst or step of PLAN; payload word 0 is the id
    rng = np.random.default_rng(seed)
    n_shards, out, op_id = N, [], 0
    for action, arg in PLAN:
        if action == "grow":
            n_shards += arg
        elif action == "shrink":
            n_shards -= len(arg)
        else:
            k = K if action == "burst" else 1
            nL = n_shards * L
            if kind == "lifo":   # push waves and pop waves (slot depth)
                E = np.repeat((rng.random(k) < arg)[:, None], nL, 1)
            else:
                E = rng.random((k, nL)) < arg
            V = rng.random((k, nL)) < 0.9
            P = np.zeros((k, nL, W), np.int32)
            P[..., 0] = np.arange(op_id, op_id + k * nL).reshape(k, nL)
            P[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (k, nL),
                                     dtype=np.int64).astype(np.int32)
            op_id += k * nL
            out.append((E, V, P))
    return out


def run(kind, rt):
    if kind in ("fifo", "seed"):    # "seed": the five-exchange seed wave
        q = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                               fused=kind == "fifo", runtime=rt)
    else:
        q = ElasticDeviceStack(N, cap=CAP, payload_width=W, ops_per_shard=L,
                               slot_depth=D, runtime=rt)
    ops = make_ops("lifo" if kind == "lifo" else "fifo")
    out, counts, b, m = {}, [], 0, 0
    for action, arg in PLAN:
        x0, g0 = rt.n_exchanges, rt.n_gathers
        if action in ("burst", "step"):
            E, V, P = ops[b]
            if action == "step":
                o = q.step(E[0], V[0], P[0])
                lead = 0
            else:
                o = q.run_waves(E, V, P)
                lead = 1
            counts.append([action, len(E), rt.n_exchanges - x0,
                           rt.n_gathers - g0])
            for name, x in zip(("pos", "m", "dv", "dok"), o):
                out[f"b{b}_{name}"] = rt.to_host(x, q.shards, lead)
            out[f"b{b}_ovf"] = rt.host_reduce(o[4], "any")
            b += 1
        else:
            st = q.grow(arg) if action == "grow" else q.shrink(arg)
            counts.append([action, 0, rt.n_exchanges - x0,
                           rt.n_gathers - g0])
            out[f"mig{m}"] = np.array([st["moved"], q.size, st["P_to"],
                                       st["collectives"]])
            m += 1
    st = q.state
    sharded = ((st.vals[:, :CAP], st.ticks[:, :CAP]) if kind == "lifo"
               else (st.store_vals[:, :CAP], st.store_full[:, :CAP]))
    for i, x in enumerate(sharded):
        g = rt.gather(x, q.shards) if rt.multi_process else x
        out[f"final{i}"] = rt.to_host(g)
    for i, x in enumerate(st[:2]):
        out[f"carry{i}"] = rt.to_host(x)
    out["ids"] = np.array([s.id for s in q.shards])
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode() + np.ascontiguousarray(out[k]).tobytes())
    return out, counts, h.hexdigest()


def metric_rows(rt):
    # the Wavescope rows of FIFO bursts around the interleaving LEAVE/JOIN
    q = ElasticDeviceQueue(N, cap=16, payload_width=W, ops_per_shard=L,
                           metrics=True, runtime=rt)
    rng = np.random.default_rng(5)
    rows = []
    for action in ("burst", "shrink", "burst", "grow", "burst"):
        if action == "shrink":
            q.shrink([2, 3, 4, 5])
        elif action == "grow":
            q.grow(4)
        else:
            n = q.n_shards * L
            q.run_waves(rng.random((K, n)) < 0.6, np.ones((K, n), bool),
                        np.zeros((K, n, W), np.int32))
            rows.append(q.trajectory())
    return rows
"""

CHILD = r"""
import json, sys
import numpy as np
from repro_torch.runtime import DistributedRuntime
rt = DistributedRuntime.from_env(device="cpu")
assert rt.process_role.count == 2 and rt.pool_size == 8
assert [d.id for d in rt.local_devices()] == [4 * rt.rank + i
                                              for i in range(4)]
result = {"metrics": metric_rows(rt)}
for kind in ("fifo", "lifo", "seed"):
    out, counts, digest = run(kind, rt)
    if rt.process_role.coordinator:
        np.savez(f"{sys.argv[1]}/{kind}.npz", **out)
    result[kind] = {"counts": counts, "digest": digest}

# what the reference runs on one process only refuses the multi-process
# runtime, naming the reference's own limit
from repro_torch.dqueue import DeviceQueue, ElasticDeviceQueue, WorkQueue
refused = []
for name, make in [
        ("workqueue", lambda: WorkQueue(DeviceQueue(8, cap=8, runtime=rt))),
        ("save", lambda: ElasticDeviceQueue(8, cap=8, runtime=rt).save(
            sys.argv[1] + "/ckpt", 1)),
        ("restore", lambda: ElasticDeviceQueue.restore(
            sys.argv[1] + "/ckpt", 1, runtime=rt))]:
    try:
        make()
    except NotImplementedError as e:
        refused.append([name, str(e)])
result["refused"] = refused
result["snapshot"] = rt.snapshot()
rt.close()
print("RESULT" + json.dumps(result))
"""


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    res = launch_localhost(code=SCHEDULE + CHILD, args=[str(tmp)],
                           n_procs=2, shards_per_process=4, timeout=240)
    parsed = []
    for r in res:
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")]
        assert line, r.stderr
        parsed.append(json.loads(line[0][len("RESULT"):]))
    arrays = {k: dict(np.load(tmp / f"{k}.npz"))
              for k in ("fifo", "lifo", "seed")}
    return parsed, arrays


@pytest.fixture(scope="module")
def one_process():
    ns = {}
    exec(SCHEDULE, ns)
    out = {"metrics": ns["metric_rows"](LocalRuntime(8, device="cpu"))}
    for kind in ("fifo", "lifo", "seed"):
        rt = LocalRuntime(8, device="cpu")
        out[kind] = ns["run"](kind, rt)
    return out


@pytest.fixture(scope="module")
def jax_fifo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_jax")
    ns = {}
    exec(SCHEDULE, ns)
    arrays = {}
    for i, (E, V, P) in enumerate(ns["make_ops"]("fifo")):
        arrays.update({f"E{i}": E, f"V{i}": V, f"P{i}": P})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}"
              f"\nPLAN = {ns['PLAN']!r}\n" + r"""
import numpy as np, jax.numpy as jnp
from repro.dqueue import ElasticDeviceQueue
d = np.load(IN)
q = ElasticDeviceQueue(8, cap=64, payload_width=2, ops_per_shard=4)
out, b, m = {}, 0, 0
for action, arg in PLAN:
    if action in ("burst", "step"):
        E, V, P = (jnp.asarray(d[f"{c}{b}"]) for c in "EVP")
        o = (q.step(E[0], V[0], P[0]) if action == "step"
             else q.run_waves(E, V, P))
        for name, x in zip(("pos", "m", "dv", "dok", "ovf"), o):
            out[f"b{b}_{name}"] = np.asarray(x)
        b += 1
    else:
        st = q.grow(arg) if action == "grow" else q.shrink(arg)
        out[f"mig{m}"] = np.array([st["moved"], q.size, st["P_to"]])
        m += 1
for k, v in q._state_dict().items():
    out[f"final_{k}"] = np.asarray(v)
out["ids"] = np.array(q.device_ids)
np.savez(OUT, **out)
print("ok")
""")
    run_multidev(script, n_dev=8, timeout=300)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("kind", ["fifo", "lifo", "seed"])
def test_two_processes_equal_one_process(two_process, one_process, kind):
    parsed, arrays = two_process
    want, _, digest = one_process[kind]
    got = arrays[kind]
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        assert np.array_equal(got[k], want[k]), k
    # both processes saw the same global outputs, and so did one process
    assert parsed[0][kind]["digest"] == parsed[1][kind]["digest"] == digest
    assert got["ids"].tolist() == [0, 1, 6, 7, 2, 3, 4, 5]


@pytest.mark.parametrize("kind", ["fifo", "lifo", "seed"])
def test_exchange_and_gather_budget(two_process, one_process, kind):
    parsed, _ = two_process
    lifo = kind == "lifo"
    # a wave's exchanges: the fused burst K+1 (pipelined) and a step 2;
    # the seed wave 5 a wave
    budget = ({"burst": lambda k: 5 * k, "step": lambda k: 5}
              if kind == "seed" else
              {"burst": lambda k: k + 1, "step": lambda k: 2})
    for rank in (0, 1):
        for action, k, ex, ga in parsed[rank][kind]["counts"]:
            if action in budget:
                assert ex == budget[action](k) and ga == k + lifo, (
                    action, ex, ga)
            else:
                assert ex == 1 and ga == 1, (action, ex, ga)
    for action, k, ex, ga in one_process[kind][1]:
        assert ex == budget[action](k) if action in budget else ex == 1
        assert ga == 0
    snap = parsed[0]["snapshot"]
    assert snap["kind"] == "distributed" and snap["process_count"] == 2


def test_metrics_rows_equal_one_process(two_process, one_process):
    """Each process drains the gathered Wavescope rows: the same as one
    process's, around the interleaving LEAVE and JOIN."""
    parsed, _ = two_process
    want = one_process["metrics"]
    assert len(want) == 3 and all(want)
    assert parsed[0]["metrics"] == parsed[1]["metrics"] == want


def test_two_process_fifo_matches_jax(two_process, jax_fifo):
    _, arrays = two_process
    got = arrays["fifo"]
    for k in jax_fifo:
        if k.startswith("b"):
            assert np.array_equal(got[k], jax_fifo[k]), k
        elif k.startswith("mig"):
            assert np.array_equal(got[k][:3], jax_fifo[k]), k
    assert got["ids"].tolist() == jax_fifo["ids"].tolist()
    cap = 64
    assert np.array_equal(got["final0"], jax_fifo["final_store_vals"][
        :, :cap])
    assert np.array_equal(got["final1"], jax_fifo["final_store_full"][
        :, :cap])
    assert int(got["carry0"]) == int(jax_fifo["final_first"])
    assert int(got["carry1"]) == int(jax_fifo["final_last"])


def test_unported_structures_refuse_two_processes(two_process):
    """WorkQueue and save/restore stay on one process, as in the
    reference (whose two-process runs raise at these lines); the message
    names the reference's limit, not a port still to do."""
    parsed, _ = two_process
    where = {"workqueue": "repro/dqueue/work_queue.py:178-179",
             "save": "repro/checkpoint/checkpointer.py:53",
             "restore": "repro/checkpoint/checkpointer.py:53"}
    for p in parsed:
        assert [name for name, _ in p["refused"]] == ["workqueue", "save",
                                                      "restore"]
        for name, msg in p["refused"]:
            assert where[name] in msg, msg
            assert "repro/runtime/distributed.py:18-20" in msg, msg
            assert "not ported" not in msg, msg


def test_launcher_reports_a_failing_child():
    with pytest.raises(RuntimeError, match="boom"):
        launch_localhost(code="import sys; sys.exit('boom')", n_procs=2,
                         timeout=60)
    res = launch_localhost(code="import os; print(os.environ["
                                "'REPRO_RT_SHARDS'], os.environ"
                                "['REPRO_RT_PID'])",
                           n_procs=2, shards_per_process=3, timeout=60)
    assert [r.stdout.split() for r in res] == [["3", "0"], ["3", "1"]]
    with pytest.raises(ValueError):
        launch_localhost(n_procs=2)


def test_from_env_names_the_missing_variable(monkeypatch):
    from repro_torch.runtime import DistributedRuntime
    for v in ("REPRO_RT_COORD", "REPRO_RT_NPROCS", "REPRO_RT_PID",
              "REPRO_RT_SHARDS"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="REPRO_RT_COORD"):
        DistributedRuntime.from_env(device="cpu")
    with pytest.raises(RuntimeError, match="initialised"):
        DistributedRuntime(4, device="cpu")
