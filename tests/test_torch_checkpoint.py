"""Checkpoints and the fault layer of the port against the JAX package.

Both packages write the same on-disk format (``step_<N>/manifest.json``
plus one raw-byte ``.npy`` per leaf), so each restores the other's.  In
one forced-multi-device subprocess the JAX package drives each of the
four elastic structures (FIFO, LIFO, priority with relaxation 1, Seap)
at 4 shards, saves it, restores it at 6 shards and runs one more burst;
it also restores the checkpoints the port wrote of the same structures
at 2 shards and runs a burst there, and runs ``run_with_restarts`` over
an elastic FIFO queue with a shard failure (a LEAVE with quarantine, a
regrow JOIN), a whole-job failure (a restart from the latest checkpoint)
and a failure of a device named by its stable id.  The port restores the
JAX checkpoints and its own the same way and runs the same bursts and
the same fault schedule on ``device="cpu"``: every output, the final
state (junk slot excluded), the migration counts, the accounting dict,
the served stream and the shard ids must be equal.  Also: the round
trip of a mixed tree (bf16 included), the atomic commit and the
non-blocking writer; and that importing each new module of the port
loads no JAX.
"""
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from multidev import run_multidev
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    restore_sharded, save_checkpoint)
from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                ElasticDeviceQueue, ElasticDeviceSeapQueue,
                                ElasticDeviceStack)
from repro_torch.fault import (FailureInjector, ShardFailure,
                               SimulatedFailure, elastic_queue_policy,
                               run_with_restarts)

ROOT = Path(__file__).resolve().parents[1]
CAP, W, L, K = 32, 2, 4, 3
KINDS = ("queue", "stack", "pqueue", "squeue")
STEP = 3


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


# ----------------------------------------------------------- round trip ---
def test_round_trip_and_atomic_commit(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.tensor([1.5, -2.25, 3.0]).to(torch.bfloat16),
            "nest": {"z": torch.tensor(7, dtype=torch.int32),
                     "flags": torch.tensor([True, False, True])},
            "pair": _Pair(torch.tensor([-1, 2 ** 31 - 1], dtype=torch.int32),
                          [np.int64(5), np.arange(3, dtype=np.int16)])}
    path = save_checkpoint(tmp_path, 4, tree, meta={"note": "x"})
    man = json.loads((path / "manifest.json").read_text())
    assert [m["key"] for m in man["leaves"]] == [
        "h", "nest__flags", "nest__z", "pair__a", "pair__b__0",
        "pair__b__1", "w"]
    assert man["leaves"][0]["dtype"] == "bfloat16" and man["meta"] == {
        "note": "x"}
    got, m2 = load_checkpoint(tmp_path, None, tree)
    assert m2["step"] == 4
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            tree["h"])
    assert torch.equal(got["nest"]["flags"], tree["nest"]["flags"])
    assert got["nest"]["z"].shape == () and int(got["nest"]["z"]) == 7
    assert isinstance(got["pair"], _Pair)
    assert int(got["pair"].b[0]) == 5 and got["pair"].b[1].tolist() == [0, 1,
                                                                         2]
    assert torch.equal(got["w"], tree["w"])
    # a crash mid-save leaves a .tmp directory that is never the latest
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_8").mkdir()           # no manifest: not committed
    assert latest_step(tmp_path) == 4
    # an existing step is kept as it is
    save_checkpoint(tmp_path, 4, {"w": torch.zeros(1)})
    assert torch.equal(load_checkpoint(tmp_path, 4, tree)[0]["w"], tree["w"])
    th = save_checkpoint(tmp_path, 5, tree, blocking=False)
    th.join()
    assert latest_step(tmp_path) == 5
    placed, _ = restore_sharded(tmp_path, 5, tree, "cpu")
    assert placed["w"].device.type == "cpu"
    assert latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "none", None, tree)


def test_jax_reads_the_port_format_in_process(tmp_path):
    # a single-device round trip in both directions, bf16 and 0-d leaves
    tree = {"a": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
            "b": torch.tensor(2.5).to(torch.bfloat16),
            "c": torch.tensor([True, False])}
    save_checkpoint(tmp_path / "p", 1, tree)
    jtree, _ = j_load_checkpoint(tmp_path / "p", 1,
                                 {k: np.zeros(1) for k in tree})
    assert np.asarray(jtree["a"]).tolist() == [[1, 2], [3, 4]]
    assert float(np.asarray(jtree["b"], np.float32)) == 2.5
    assert np.asarray(jtree["c"]).tolist() == [True, False]
    j_save_checkpoint(tmp_path / "j", 2, {k: np.asarray(
        v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
        for k, v in tree.items()})
    back, _ = load_checkpoint(tmp_path / "j", 2, tree)
    assert back["a"].tolist() == [[1, 2], [3, 4]]
    assert back["c"].tolist() == [True, False]


# ---------------------------------------------------- elastic structures ---
def _bursts(kind, n, seed, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        nL = n * L
        if kind == "stack":
            E = np.repeat(np.array([True, True, False])[:, None], nL, 1)
        else:
            E = rng.random((K, nL)) < 0.5
        V = rng.random((K, nL)) < 0.9
        key = (rng.integers(-100, 100, (K, nL)) if kind == "squeue"
               else rng.integers(0, 3, (K, nL))).astype(np.int32)
        PW = rng.integers(0, 1 << 20, (K, nL, W)).astype(np.int32)
        out.append((E, V, key, PW))
    return out


def _args(kind, burst, mod):
    E, V, KY, PW = (mod(x) for x in burst)
    return (E, V, PW) if kind in ("queue", "stack") else (E, V, KY, PW)


JAX_SCRIPT = r"""
import json
import numpy as np, jax.numpy as jnp
from repro.dqueue import (ElasticDevicePriorityQueue, ElasticDeviceQueue,
                          ElasticDeviceSeapQueue, ElasticDeviceStack)
from repro.fault import FailureInjector, elastic_queue_policy, run_with_restarts
d = np.load(IN)
out = {}
CLS = {"queue": ElasticDeviceQueue, "stack": ElasticDeviceStack,
       "pqueue": ElasticDevicePriorityQueue, "squeue": ElasticDeviceSeapQueue}
def make(kind):
    kw = dict(cap=CAP, payload_width=W, ops_per_shard=L)
    if kind == "stack":
        kw["slot_depth"] = 4
    if kind == "pqueue":
        kw.update(n_prios=3, relaxation=1)
    if kind == "squeue":
        kw.update(n_buckets=4, split_occupancy=6, seed_bounds=[0])
    return CLS[kind](4, **kw)
def args(kind, tag):
    xs = [jnp.asarray(d[f"{kind}_{tag}_{c}"]) for c in "EVKP"]
    return xs if kind in ("pqueue", "squeue") else [xs[0], xs[1], xs[3]]
def record(prefix, eq, outs):
    for i, v in enumerate(outs):
        out[f"{prefix}_o{i}"] = np.asarray(v)
    for k, v in eq._state_dict().items():
        out[f"{prefix}_s_{k}"] = np.asarray(v)
for kind in KINDS:
    eq = make(kind)
    for b in range(2):
        eq.run_waves(*args(kind, f"b{b}"))
    record(f"{kind}_pre", eq, [])
    eq.save(f"{JDIR}/{kind}", STEP)
    r6 = CLS[kind].restore(f"{JDIR}/{kind}", n_shards=6)
    record(f"{kind}_j6", r6, r6.run_waves(*args(kind, "six")))
    out[f"{kind}_j6_moved"] = np.array(r6.migrations[-1]["moved"])
    r2 = CLS[kind].restore(f"{PDIR}/{kind}", n_shards=2)
    record(f"{kind}_p2", r2, r2.run_waves(*args(kind, "two")))

# run_with_restarts: shard LEAVE + regrow JOIN, a restart, a device LEAVE
q = ElasticDeviceQueue(4, cap=64, payload_width=2, ops_per_shard=4)
got = []
def step_fn(state, step):
    n = q.n_shards * q.L
    e = np.zeros(n, bool); v = np.zeros(n, bool)
    pw = np.zeros((n, 2), np.int32)
    e[:4] = v[:4] = True
    pw[:4, 0] = np.arange(step * 4, step * 4 + 4)
    v[4:7] = True
    _, _, dv, dok, _ = q.step(e, v, pw)
    dv, dok = np.asarray(dv), np.asarray(dok)
    got.extend(int(dv[i, 0]) for i in range(n) if dok[i])
    return {"done": np.int64(step + 1), "size": np.int32(q.size)}
state, metrics = run_with_restarts(
    init_state=lambda: {"done": np.int64(0), "size": np.int32(0)},
    step_fn=step_fn, n_steps=12, ckpt_dir=f"{JDIR}/fault", ckpt_every=4,
    injector=FailureInjector(**INJ), elastic=elastic_queue_policy(
        q, regrow_after=2), log=lambda *a: None)
out["fault"] = json.dumps({"metrics": metrics, "got": got,
                           "ids": q.device_ids, "size": q.size,
                           "state": {k: int(np.asarray(v))
                                     for k, v in state.items()}})
np.savez(OUT, **out)
print("ok")
"""
INJ = {"shard_fail_at": {3: 1}, "fail_at_steps": (6,),
       "device_fail_at": {9: 2}}


def _make(kind, n, **kw):
    kw.update(cap=CAP, payload_width=W, ops_per_shard=L, device="cpu")
    if kind == "stack":
        return ElasticDeviceStack(n, slot_depth=4, **kw)
    if kind == "pqueue":
        return ElasticDevicePriorityQueue(n, n_prios=3, relaxation=1, **kw)
    if kind == "squeue":
        return ElasticDeviceSeapQueue(n, n_buckets=4, split_occupancy=6,
                                      seed_bounds=[0], **kw)
    return ElasticDeviceQueue(n, **kw)


CLS = {"queue": ElasticDeviceQueue, "stack": ElasticDeviceStack,
       "pqueue": ElasticDevicePriorityQueue, "squeue": ElasticDeviceSeapQueue}


def _inputs():
    arrays = {}
    for i, kind in enumerate(KINDS):
        for tag, n, bursts in (("b", 4, _bursts(kind, 4, i, 2)),
                               ("six", 6, _bursts(kind, 6, 10 + i, 1)),
                               ("two", 2, _bursts(kind, 2, 20 + i, 1))):
            for b, bt in enumerate(bursts):
                name = f"{tag}{b}" if tag == "b" else tag
                arrays.update({f"{kind}_{name}_{c}": x
                               for c, x in zip("EVKP", bt)})
    return arrays


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    arrays = _inputs()
    np.savez(tmp / "in.npz", **arrays)
    pre = {}
    for kind in KINDS:          # the port writes its own checkpoints first
        eq = _make(kind, 4)
        for b in range(2):
            eq.run_waves(*_args(kind, [arrays[f"{kind}_b{b}_{c}"]
                                       for c in "EVKP"], torch.from_numpy))
        pre[kind] = {k: v.numpy() for k, v in eq._state_dict().items()}
        eq.save(tmp / "port" / kind, STEP)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}"
              f"\nJDIR = {str(tmp / 'jax')!r}\nPDIR = {str(tmp / 'port')!r}"
              f"\nCAP, W, L, STEP = {CAP}, {W}, {L}, {STEP}\n"
              f"KINDS = {KINDS!r}\nINJ = {INJ!r}\n" + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=900)
    return tmp, arrays, pre, dict(np.load(tmp / "out.npz"))


def _junk(kind):
    return {"queue": CAP, "stack": CAP, "pqueue": 3 * CAP,
            "squeue": 4 * CAP}[kind]


def _assert_state(kind, got: dict, want: dict, prefix: str):
    for k, v in got.items():
        w = want[f"{prefix}_s_{k}"]
        if k in ("store_vals", "vals"):       # junk slot unspecified
            v, w = v[:, :_junk(kind)], w[:, :_junk(kind)]
        np.testing.assert_array_equal(v, w, err_msg=f"{prefix} {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_port_state_before_the_save_matches_jax(ckpts, kind):
    _, _, pre, out = ckpts
    _assert_state(kind, pre[kind], out, f"{kind}_pre")


@pytest.mark.parametrize("kind", KINDS)
def test_port_restores_a_jax_checkpoint_at_another_shard_count(ckpts, kind):
    tmp, arrays, _, out = ckpts
    man = json.loads((tmp / "jax" / kind / f"step_{STEP}" /
                      "manifest.json").read_text())
    eq = CLS[kind].restore(tmp / "jax" / kind, n_shards=6, device="cpu")
    assert eq.n_shards == 6 and eq.pool_size == 6
    assert eq._layout() == {**man["meta"]["layout"], "n_shards": 6}
    assert eq.migrations[-1]["moved"] == int(out[f"{kind}_j6_moved"])
    outs = eq.run_waves(*_args(kind, [arrays[f"{kind}_six_{c}"]
                                      for c in "EVKP"], torch.from_numpy))
    for i, v in enumerate(outs):
        np.testing.assert_array_equal(v.numpy(), out[f"{kind}_j6_o{i}"])
    _assert_state(kind, {k: v.numpy() for k, v in eq._state_dict().items()},
                  out, f"{kind}_j6")


@pytest.mark.parametrize("kind", KINDS)
def test_jax_restores_a_port_checkpoint(ckpts, kind):
    # JAX restored the port's checkpoint at 2 shards and ran a burst; the
    # port does the same from its own checkpoint
    tmp, arrays, _, out = ckpts
    eq = CLS[kind].restore(tmp / "port" / kind, STEP, n_shards=2,
                           device="cpu")
    assert eq.migrations[-1]["kind"] == "shrink"
    outs = eq.run_waves(*_args(kind, [arrays[f"{kind}_two_{c}"]
                                      for c in "EVKP"], torch.from_numpy))
    for i, v in enumerate(outs):
        np.testing.assert_array_equal(v.numpy(), out[f"{kind}_p2_o{i}"])
    _assert_state(kind, {k: v.numpy() for k, v in eq._state_dict().items()},
                  out, f"{kind}_p2")


def test_restore_refuses_another_kind(ckpts):
    tmp = ckpts[0]
    with pytest.raises(ValueError, match="holds a stack"):
        ElasticDeviceQueue.restore(tmp / "port" / "stack", device="cpu")
    with pytest.raises(FileNotFoundError):
        ElasticDeviceQueue.restore(tmp / "nothing", device="cpu")


# ------------------------------------------------------------ fault layer -
def test_run_with_restarts_matches_jax(ckpts, tmp_path):
    want = json.loads(str(ckpts[3]["fault"]))
    q = ElasticDeviceQueue(4, cap=64, payload_width=2, ops_per_shard=4,
                           pool_size=8, device="cpu")
    got = []

    def step_fn(state, step):
        n = q.n_shards * q.L
        e = torch.zeros(n, dtype=torch.bool)
        v = torch.zeros(n, dtype=torch.bool)
        pw = torch.zeros((n, 2), dtype=torch.int32)
        e[:4] = v[:4] = True
        pw[:4, 0] = torch.arange(step * 4, step * 4 + 4)
        v[4:7] = True
        _, _, dv, dok, _ = q.step(e, v, pw)
        got.extend(int(x) for x in dv[dok, 0])
        return {"done": np.int64(step + 1), "size": np.int32(q.size)}

    inj = FailureInjector(**INJ)
    state, metrics = run_with_restarts(
        init_state=lambda: {"done": np.int64(0), "size": np.int32(0)},
        step_fn=step_fn, n_steps=12, ckpt_dir=tmp_path, ckpt_every=4,
        injector=inj, elastic=elastic_queue_policy(q, regrow_after=2),
        log=lambda *a: None)
    assert metrics == want["metrics"]
    assert metrics["leaves"] == 2 and metrics["restarts"] == 1
    assert got == want["got"] and q.device_ids == want["ids"]
    assert q.size == want["size"]
    assert {k: int(v) for k, v in state.items()} == want["state"]
    assert 1 not in q.device_ids and 2 not in q.device_ids
    assert len(q.runtime.pool()) == 6       # both quarantined for good
    assert latest_step(tmp_path) == 12


def test_injector_and_policy_without_a_queue(tmp_path):
    events = []
    from repro_torch.fault import ElasticPolicy
    policy = ElasticPolicy(
        shrink=lambda st, shard: (events.append(("leave", shard)), st)[1],
        regrow=lambda st: (events.append(("join",)), st)[1],
        regrow_after=2)
    inj = FailureInjector(shard_fail_at={1: 0}, fail_at_steps=(2,))
    _, metrics = run_with_restarts(
        init_state=lambda: {"x": np.int64(0)},
        step_fn=lambda st, step: {"x": np.int64(step + 1)},
        n_steps=8, ckpt_dir=tmp_path, ckpt_every=100, injector=inj,
        elastic=policy, log=lambda *a: None)
    assert metrics == {"restarts": 1, "steps_replayed": 0, "steps_run": 10,
                       "leaves": 1, "joins": 1}
    assert events == [("leave", 0), ("join",)]
    # without a policy a shard failure is a failure like any other: a
    # restart, and past max_restarts it propagates
    _, m = run_with_restarts(init_state=lambda: {}, step_fn=lambda s, i: s,
                             n_steps=3, ckpt_dir=tmp_path / "b",
                             injector=FailureInjector(shard_fail_at={1: 0}),
                             log=lambda *a: None)
    assert m["restarts"] == 1 and m["leaves"] == 0
    with pytest.raises(ShardFailure):
        run_with_restarts(init_state=lambda: {}, step_fn=lambda s, i: s,
                          n_steps=3, ckpt_dir=tmp_path / "d",
                          injector=FailureInjector(shard_fail_at={1: 0}),
                          max_restarts=0, log=lambda *a: None)
    with pytest.raises(SimulatedFailure):
        run_with_restarts(init_state=lambda: {}, step_fn=lambda s, i: s,
                          n_steps=3, ckpt_dir=tmp_path / "c",
                          injector=FailureInjector(fail_at_steps=(1,)),
                          max_restarts=0, log=lambda *a: None)


@pytest.mark.parametrize("module", [
    "repro_torch.checkpoint", "repro_torch.fault", "repro_torch.obs",
    "repro_torch.obs.__main__", "repro_torch.kernels.relaxed",
    "repro_torch.kernels.relaxed.kernel", "repro_torch.dqueue"])
def test_new_modules_load_no_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
