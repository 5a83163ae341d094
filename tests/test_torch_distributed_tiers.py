"""The priority and Seap queues in two processes under gloo, against one
process and against JAX.

``launch_localhost`` starts two CPU processes, each holding 4 of 8 shards
of a ``DistributedRuntime``.  Each drives an elastic 3-tier priority
queue (strict), the same with ``relaxation=1``, and an elastic 4-bucket
Seap queue whose keys cluster at both int32 edges, through the schedule
of ``test_torch_distributed.py``: bursts, a single step, a LEAVE of the
shards with indices 2-5, then JOINs of 2 and 2, which leave the active
order ``[0, 1, 6, 7, 2, 3, 4, 5]`` (process 0's shards split around
process 1's).  A few priority enqueues carry tiers outside ``[0, 3)``,
one of them past 2^30, which the reference's descriptor wraps into a
tier.

The per-op outputs (gathered by ``to_host``), the relaxed-serve counts,
the Seap directory after every burst, the migrations' moved counts and
the final store and carry (gathered in active order) must be
bit-identical to the same schedule on one process's LocalRuntime, and to
the JAX package's elastic structures on a forced 8-device mesh.  These
are int32 paths: the tolerance is zero.  The exchange budget holds on
both runtimes (K+1 a pipelined burst, 2 a step, 1 a migration), and the
two-process run adds one gather a wave (the descriptors) and one a
migration (the moved count and lost flag).  The Wavescope rows each
process drains (gathered) equal one process's.
"""
import json

import numpy as np
import pytest

from multidev import run_multidev

from repro_torch.runtime import LocalRuntime, launch_localhost

KINDS = ("priority", "relaxed", "seap")

# the schedule both runtimes run; ``run`` returns global host arrays
SCHEDULE = r"""
import hashlib
import numpy as np
from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                ElasticDeviceSeapQueue)

N, CAP, W, L, K = 8, 64, 2, 4, 3
P_, B, OCC = 3, 4, 20
I32MIN, I32MAX = -2 ** 31, 2 ** 31 - 1
PLAN = [("burst", 0.7), ("burst", 0.7), ("step", 0.6),
        ("shrink", [2, 3, 4, 5]), ("burst", 0.5), ("grow", 2),
        ("burst", 0.6), ("grow", 2), ("burst", 0.4), ("burst", 0.0),
        ("burst", 0.0), ("burst", 0.0)]
OUTS = {"seap": ("bucket", "pos", "m", "dv", "dok", "ovf", "aux"),
        "priority": ("tier", "pos", "m", "dv", "dok", "ovf", "aux")}


def make_ops(kind, seed=7):
    # one (E, V, KY, P) per burst or step of PLAN; payload word 0 is the
    # op's id.  Priority keys are tiers, 8% of them outside [0, P_);
    # Seap keys drift upwards burst by burst, 10% at each int32 edge
    rng = np.random.default_rng(seed)
    n_shards, out, op_id = N, [], 0
    for b, (action, arg) in enumerate(PLAN):
        if action == "grow":
            n_shards += arg
        elif action == "shrink":
            n_shards -= len(arg)
        else:
            k = K if action == "burst" else 1
            nL = n_shards * L
            E = rng.random((k, nL)) < arg
            V = rng.random((k, nL)) < 0.9
            edge = rng.random((k, nL))
            if kind == "seap":
                KY = rng.integers(-1000, 1000, (k, nL)) + 300 * b
                KY[edge < 0.1] = I32MIN + rng.integers(0, 2, (k, nL))[
                    edge < 0.1]
                KY[edge > 0.9] = I32MAX - rng.integers(0, 2, (k, nL))[
                    edge > 0.9]
            else:
                KY = rng.integers(0, P_, (k, nL))
                odd = np.array([-1, P_, 2 ** 30 + 1])
                KY[edge < 0.08] = odd[rng.integers(0, 3, (k, nL))][
                    edge < 0.08]
            P = np.zeros((k, nL, W), np.int32)
            P[..., 0] = np.arange(op_id, op_id + k * nL).reshape(k, nL)
            P[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (k, nL),
                                     dtype=np.int64).astype(np.int32)
            op_id += k * nL
            out.append((E, V, KY.astype(np.int32), P))
    return out


def make_queue(kind, rt, metrics=False, cap=CAP):
    if kind == "seap":
        return ElasticDeviceSeapQueue(N, n_buckets=B, split_occupancy=OCC,
                                      cap=cap, payload_width=W,
                                      ops_per_shard=L, metrics=metrics,
                                      runtime=rt)
    return ElasticDevicePriorityQueue(N, n_prios=P_,
                                      relaxation=int(kind == "relaxed"),
                                      cap=cap, payload_width=W,
                                      ops_per_shard=L, metrics=metrics,
                                      runtime=rt)


def run(kind, rt):
    q = make_queue(kind, rt)
    names = OUTS["seap" if kind == "seap" else "priority"]
    ops = make_ops(kind)
    out, counts, b, m = {}, [], 0, 0
    for action, arg in PLAN:
        x0, g0 = rt.n_exchanges, rt.n_gathers
        if action in ("burst", "step"):
            E, V, KY, P = ops[b]
            if action == "step":
                o = q.step(E[0], V[0], KY[0], P[0])
                lead = 0
            else:
                o = q.run_waves(E, V, KY, P)
                lead = 1
            counts.append([action, len(E), rt.n_exchanges - x0,
                           rt.n_gathers - g0])
            for name, x in zip(names, o):
                out[f"b{b}_{name}"] = (rt.to_host(x, q.shards, lead)
                                       if name in ("tier", "bucket", "pos",
                                                   "m", "dv", "dok")
                                       else rt.to_host(x))
            if kind == "seap":
                out[f"b{b}_dir"] = np.array(q.directory())
            b += 1
        else:
            st = q.grow(arg) if action == "grow" else q.shrink(arg)
            counts.append([action, 0, rt.n_exchanges - x0,
                           rt.n_gathers - g0])
            out[f"mig{m}"] = np.array([st["moved"], q.size, st["P_to"],
                                       st["collectives"]] + q.sizes)
            m += 1
    st = q.state
    junk = st.store_vals.shape[1] - 1
    for name in ("store_vals", "store_full"):
        x = getattr(st, name)[:, :junk]
        g = rt.gather(x, q.shards) if rt.multi_process else x
        out[f"final_{name}"] = rt.to_host(g)
    for name in st._fields:
        if not name.startswith("store"):
            out[f"final_{name}"] = rt.to_host(getattr(st, name))
    out["ids"] = np.array([s.id for s in q.shards])
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode() + np.ascontiguousarray(out[k]).tobytes())
    return out, counts, h.hexdigest()


def metric_rows(kind, rt):
    # the Wavescope rows around the interleaving LEAVE/JOIN
    q = make_queue(kind, rt, metrics=True, cap=16)
    rng = np.random.default_rng(5)
    rows = []
    for action in ("burst", "shrink", "burst", "grow", "burst"):
        if action == "shrink":
            q.shrink([2, 3, 4, 5])
        elif action == "grow":
            q.grow(4)
        else:
            n = q.n_shards * L
            key = (rng.integers(-50, 50, (K, n)) if kind == "seap"
                   else rng.integers(0, P_, (K, n)))
            q.run_waves(rng.random((K, n)) < 0.6, np.ones((K, n), bool),
                        key.astype(np.int32), np.zeros((K, n, W), np.int32))
            rows.append(q.trajectory())
    return rows
"""

CHILD = r"""
import json, sys
import numpy as np
from repro_torch.runtime import DistributedRuntime
rt = DistributedRuntime.from_env(device="cpu")
assert rt.process_role.count == 2 and rt.pool_size == 8
result = {"metrics": {k: metric_rows(k, rt) for k in ("priority", "seap")}}
for kind in ("priority", "relaxed", "seap"):
    out, counts, digest = run(kind, rt)
    if rt.process_role.coordinator:
        np.savez(f"{sys.argv[1]}/{kind}.npz", **out)
    result[kind] = {"counts": counts, "digest": digest}
rt.close()
print("RESULT" + json.dumps(result))
"""


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_tiers")
    res = launch_localhost(code=SCHEDULE + CHILD, args=[str(tmp)],
                           n_procs=2, shards_per_process=4, timeout=300)
    parsed = []
    for r in res:
        line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")]
        assert line, r.stderr
        parsed.append(json.loads(line[0][len("RESULT"):]))
    arrays = {k: dict(np.load(tmp / f"{k}.npz")) for k in KINDS}
    return parsed, arrays


@pytest.fixture(scope="module")
def one_process():
    ns = {}
    exec(SCHEDULE, ns)
    out = {"metrics": {k: ns["metric_rows"](k, LocalRuntime(8, device="cpu"))
                       for k in ("priority", "seap")}}
    for kind in KINDS:
        out[kind] = ns["run"](kind, LocalRuntime(8, device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_tiers(tmp_path_factory):
    """The same schedules on the JAX package's elastic structures, one
    forced-8-device subprocess."""
    tmp = tmp_path_factory.mktemp("dist_tiers_jax")
    ns = {}
    exec(SCHEDULE, ns)
    arrays = {}
    for kind in KINDS:
        for i, ops in enumerate(ns["make_ops"](kind)):
            arrays.update({f"{kind}_{c}{i}": x for c, x in zip(
                ("E", "V", "KY", "P"), ops)})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}"
              f"\nPLAN = {ns['PLAN']!r}\nKINDS = {KINDS!r}\n"
              f"CFG = {(ns['P_'], ns['B'], ns['OCC'], ns['CAP'])!r}\n" + r"""
import numpy as np, jax.numpy as jnp
from repro.dqueue import ElasticDevicePriorityQueue, ElasticDeviceSeapQueue
P_, B, OCC, CAP = CFG
d = np.load(IN)
out = {}
for kind in KINDS:
    if kind == "seap":
        q = ElasticDeviceSeapQueue(8, n_buckets=B, split_occupancy=OCC,
                                   cap=CAP, payload_width=2, ops_per_shard=4)
    else:
        q = ElasticDevicePriorityQueue(8, n_prios=P_,
                                       relaxation=int(kind == "relaxed"),
                                       cap=CAP, payload_width=2,
                                       ops_per_shard=4)
    b, m = 0, 0
    for action, arg in PLAN:
        if action in ("burst", "step"):
            E, V, KY, P = (jnp.asarray(d[f"{kind}_{c}{b}"])
                           for c in ("E", "V", "KY", "P"))
            o = (q.step(E[0], V[0], KY[0], P[0]) if action == "step"
                 else q.run_waves(E, V, KY, P))
            for name, x in zip(("key", "pos", "m", "dv", "dok", "ovf",
                                "aux"), o):
                out[f"{kind}_b{b}_{name}"] = np.asarray(x)
            if kind == "seap":
                out[f"{kind}_b{b}_dir"] = np.array(q.directory())
            b += 1
        else:
            st = q.grow(arg) if action == "grow" else q.shrink(arg)
            out[f"{kind}_mig{m}"] = np.array([st["moved"], q.size,
                                              st["P_to"]] + list(q.sizes))
            m += 1
    for k, v in q._state_dict().items():
        out[f"{kind}_final_{k}"] = np.asarray(v)
    out[f"{kind}_ids"] = np.array(q.device_ids)
np.savez(OUT, **out)
print("ok")
""")
    run_multidev(script, n_dev=8, timeout=600)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("kind", KINDS)
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


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_exercises_the_path(one_process, kind):
    """The schedule is not vacuous: elements are served, the queue drains
    to ⊥, the relaxed queue serves some dequeue relaxed, the strict one
    none, and the Seap directory splits."""
    out = one_process[kind][0]
    bursts = sorted({k.split("_")[0] for k in out if k[0] == "b"})
    if kind != "seap":      # tiers the descriptor wraps, enqueued
        ns = {}
        exec(SCHEDULE, ns)
        assert sum(int((E & V & (KY == 2 ** 30 + 1)).sum())
                   for E, V, KY, _ in ns["make_ops"](kind)) >= 5
    assert sum(int(out[f"{b}_dok"].sum()) for b in bursts) > 100
    assert out["final_store_full"].sum() == 0
    n_rel = sum(int(np.sum(out[f"{b}_aux"])) for b in bursts)
    if kind == "seap":
        assert max(len(out[f"{b}_dir"]) for b in bursts) > 1
    else:
        assert (n_rel > 0) == (kind == "relaxed")


@pytest.mark.parametrize("kind", KINDS)
def test_exchange_and_gather_budget(two_process, one_process, kind):
    parsed, _ = two_process
    budget = {"burst": lambda k: k + 1, "step": lambda k: 2}
    for rank in (0, 1):
        for action, k, ex, ga in parsed[rank][kind]["counts"]:
            if action in budget:
                # one descriptor gather a wave, nothing else
                assert ex == budget[action](k) and ga == k, (action, ex, ga)
            else:
                # one exchange, and one gather of the moved count and the
                # lost flag
                assert ex == 1 and ga == 1, (action, ex, ga)
    for action, k, ex, ga in one_process[kind][1]:
        assert ex == budget[action](k) if action in budget else ex == 1
        assert ga == 0


@pytest.mark.parametrize("kind", ["priority", "seap"])
def test_metrics_rows_equal_one_process(two_process, one_process, kind):
    """Each process drains the gathered Wavescope rows, ``n_windows``
    occupancy columns included: the same as one process's, around the
    interleaving LEAVE and JOIN."""
    parsed, _ = two_process
    want = one_process["metrics"][kind]
    assert len(want) == 3 and all(want)
    assert parsed[0]["metrics"][kind] == parsed[1]["metrics"][kind] == want


@pytest.mark.parametrize("kind", KINDS)
def test_two_process_tiers_match_jax(two_process, jax_tiers, kind):
    _, arrays = two_process
    got = arrays[kind]
    key = "bucket" if kind == "seap" else "tier"
    n = 0
    for k, v in jax_tiers.items():
        if not k.startswith(kind + "_"):
            continue
        name = k[len(kind) + 1:]
        if name.startswith("b"):
            name = name.replace("_key", f"_{key}")
            assert np.array_equal(got[name], v), k
        elif name.startswith("mig"):
            assert np.array_equal(np.delete(got[name], 3), v), k
        elif name == "ids":
            assert got["ids"].tolist() == v.tolist()
        elif name.startswith("final_store"):
            junk = v.shape[1] - 1
            assert np.array_equal(got[name], v[:, :junk]), k
        else:
            assert np.array_equal(got[name], v), k
        n += 1
    assert n > 40
