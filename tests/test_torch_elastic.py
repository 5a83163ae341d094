"""The port's ElasticDeviceQueue against the JAX reference through JOIN/LEAVE.

The JAX ``ElasticDeviceQueue`` runs on a forced 8-device CPU mesh in one
subprocess (``multidev.run_multidev``) that writes an ``.npz``; the port
runs the same op trace and grow/shrink schedule (4 -> 6 -> 3 -> 5 shards)
on ``device="cpu"``.  Per-wave positions, matched flags, dequeued values,
ok flags and overflow flags, each migration's ``moved`` and hash balance,
and the final store (junk row excluded) must be bit-identical.  The JAX
final state is then loaded into the port through ``state_from_jax`` and
both continue for one burst.  Also: the overflow error at the exact
capacity, and the package rules (no jax, no ``repro`` import; no silent
CPU fallback).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from multidev import run_multidev
from repro.kernels.hash_route import hash_route_ref as j_hash_route_ref

from repro_torch.dqueue import (DeviceQueue, ElasticDeviceQueue,
                                QueueOverflowError)
from repro_torch.interop import state_from_jax, state_to_numpy

ROOT = Path(__file__).resolve().parents[1]
CAP, W, L, K = 32, 2, 4, 3
# (action, argument): bursts carry their enqueue share
PLAN = [("burst", 0.7), ("burst", 0.7), ("grow", 2), ("burst", 0.5),
        ("shrink", [0, 2, 4]), ("burst", 0.6), ("grow", 2), ("burst", 0.2)]
EXTRA_MIX = 0.5
KEYS = ("pos", "m", "dv", "dok", "ovf")


def _bursts(seed=0):
    """One (E, V, P) per burst of PLAN plus the extra burst; payload word 0
    is the op's global id."""
    rng = np.random.default_rng(seed)
    n_shards, out, op_id = 4, [], 0
    for action, arg in PLAN + [("burst", EXTRA_MIX)]:
        if action == "grow":
            n_shards += arg
        elif action == "shrink":
            n_shards -= len(arg)
        else:
            nL = n_shards * L
            E = rng.random((K, nL)) < arg
            V = rng.random((K, nL)) < 0.9
            P = np.zeros((K, nL, W), np.int32)
            P[..., 0] = np.arange(op_id, op_id + K * nL).reshape(K, nL)
            P[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (K, nL),
                                     dtype=np.int64).astype(np.int32)
            op_id += K * nL
            out.append((E, V, P))
    return out


JAX_SCRIPT = r"""
import numpy as np, jax.numpy as jnp
from repro.dqueue import ElasticDeviceQueue
d = np.load(IN, allow_pickle=False)
eq = ElasticDeviceQueue(4, cap=32, payload_width=2, ops_per_shard=4)
out, b, mig = {}, 0, 0
def burst(tag):
    o = eq.run_waves(jnp.asarray(d[f"E{b}"]), jnp.asarray(d[f"V{b}"]),
                     jnp.asarray(d[f"P{b}"]))
    for k, v in zip(("pos", "m", "dv", "dok", "ovf"), o):
        out[f"{tag}_{k}"] = np.asarray(v)
for action, arg in PLAN:
    if action == "burst":
        burst(f"b{b}"); b += 1
        continue
    st = eq.grow(arg) if action == "grow" else eq.shrink(arg)
    hb = st["hash_balance"]
    out[f"mig{mig}"] = np.array([st["moved"], eq.size, hb["n"], hb["max"],
                                 hb["min"], hb["roundrobin_max"], st["P_to"]])
    mig += 1
for k, v in eq._state_dict().items():
    out[f"final_{k}"] = np.asarray(v)
burst("x")
for k, v in eq._state_dict().items():
    out[f"after_{k}"] = np.asarray(v)
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    arrays = {}
    for i, (E, V, P) in enumerate(_bursts()):
        arrays.update({f"E{i}": E, f"V{i}": V, f"P{i}": P})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              f"PLAN = {PLAN!r}\n" + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=400)
    return dict(np.load(tmp / "out.npz"))


def _burst(eq, E, V, P):
    o = eq.run_waves(torch.from_numpy(E), torch.from_numpy(V),
                     torch.from_numpy(P))
    return {k: v.numpy() for k, v in zip(KEYS, o)}


@pytest.fixture(scope="module")
def port_run():
    bursts = _bursts()
    eq = ElasticDeviceQueue(4, cap=CAP, payload_width=W, ops_per_shard=L,
                            pool_size=8, device="cpu")
    out, b, migs = {}, 0, []
    for action, arg in PLAN:
        if action == "burst":
            out.update({f"b{b}_{k}": v
                        for k, v in _burst(eq, *bursts[b]).items()})
            b += 1
            continue
        x0 = eq.runtime.n_exchanges
        st = eq.grow(arg) if action == "grow" else eq.shrink(arg)
        assert eq.runtime.n_exchanges - x0 == st["collectives"] == 1
        migs.append((st, eq.size, int(eq.state.first), int(eq.state.last)))
    return eq, out, migs


def _assert_state_equal(port_state: dict, jax_run: dict, prefix: str):
    assert int(port_state["first"]) == int(jax_run[f"{prefix}_first"])
    assert int(port_state["last"]) == int(jax_run[f"{prefix}_last"])
    np.testing.assert_array_equal(port_state["store_vals"][:, :CAP],
                                  jax_run[f"{prefix}_store_vals"][:, :CAP])
    np.testing.assert_array_equal(port_state["store_full"],
                                  jax_run[f"{prefix}_store_full"])


def test_bursts_match_jax_through_join_and_leave(jax_run, port_run):
    eq, out, _ = port_run
    n_bursts = sum(a == "burst" for a, _ in PLAN)
    for b in range(n_bursts):
        for k in KEYS:
            np.testing.assert_array_equal(out[f"b{b}_{k}"],
                                          jax_run[f"b{b}_{k}"],
                                          err_msg=f"burst {b} {k}")
    assert eq.n_shards == 5 and len(eq.migrations) == 3
    _assert_state_equal(state_to_numpy(eq.state), jax_run, "final")
    # the trace exercised matched dequeues and ⊥ dequeues
    assert any(out[f"b{b}_dok"].any() for b in range(n_bursts))
    E, V, _ = _bursts()[n_bursts - 1]
    assert (V & ~E & ~out[f"b{n_bursts - 1}_m"]).any()


def test_migrations_match_jax(jax_run, port_run):
    _, _, migs = port_run
    for i, (st, size, _, _) in enumerate(migs):
        moved, jsize, n, mx, mn, rr, P_to = (int(x) for x in
                                             jax_run[f"mig{i}"])
        assert st["moved"] == moved == size == jsize
        assert st["P_to"] == P_to
        hb = st["hash_balance"]
        assert (hb["n"], hb["max"], hb["min"], hb["roundrobin_max"]) == (
            n, mx, mn, rr)
        assert sum(hb["counts"]) == hb["n"] and len(hb["counts"]) == P_to


def test_hash_balance_counts_match_jax_ref(port_run):
    eq, _, migs = port_run
    for st, _, lo, hi in migs:
        pos = jnp.arange(lo, hi + 1, dtype=jnp.int32)
        _, counts = j_hash_route_ref(pos, jnp.ones(pos.shape, bool),
                                     st["P_to"])
        assert st["hash_balance"]["counts"] == [int(c) for c in
                                                np.asarray(counts)]
    assert eq.resize(eq.n_shards)["kind"] == "noop"


def test_continue_from_jax_state(jax_run):
    bursts = _bursts()
    d = {k[len("final_"):]: v for k, v in jax_run.items()
         if k.startswith("final_")}
    eq = ElasticDeviceQueue(5, cap=CAP, payload_width=W, ops_per_shard=L,
                            pool_size=8, device="cpu")
    eq.state = state_from_jax(d, "cpu")
    got = _burst(eq, *bursts[-1])
    for k in KEYS:
        np.testing.assert_array_equal(got[k], jax_run[f"x_{k}"], err_msg=k)
    _assert_state_equal(state_to_numpy(eq.state), jax_run, "after")


def test_overflow_error_at_exact_capacity():
    eq = ElasticDeviceQueue(2, cap=2, payload_width=1, ops_per_shard=2,
                            device="cpu")
    full = np.ones((1, 4), bool)
    eq.run_waves(full, full, np.zeros((1, 4, 1), np.int32))
    assert eq.size == 4 and eq.headroom() == [0]
    assert eq.pressure()["utilization"] == 1.0
    one = np.array([[True, False, False, False]])
    with pytest.raises(QueueOverflowError) as err:
        eq.run_waves(one, one, np.zeros((1, 4, 1), np.int32))
    assert err.value.wave == 0 and err.value.capacity == 4
    assert err.value.occupancy == [5]


def test_membership_bookkeeping():
    eq = ElasticDeviceQueue(3, cap=4, payload_width=1, ops_per_shard=2,
                            pool_size=5, device="cpu")
    eq.shrink_devices([1], quarantine=True)
    assert eq.device_ids == [0, 2] and eq.pool_size == 4
    eq.grow(2)
    assert eq.device_ids == [0, 2, 3, 4]          # id 1 never comes back
    with pytest.raises(ValueError):
        eq.grow(1)
    assert eq.bucket_widths() == (1, 2) and eq.pick_width(3) == 1
    assert eq.window_capacity() == 16


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ElasticDeviceQueue(2, runtime=object())


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticDeviceQueue(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceQueue(2)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("target", ["src/repro_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_repro(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad

