"""The five-exchange seed wave (``DeviceQueue(fused=False)``) against JAX.

The reference keeps its seed Stage 4 (``_legacy_wave``: PUT slots, PUT
payloads, GET slots, reply values, reply flags, one collective each) as
the differential baseline of the fused two-exchange wave.  The JAX
``DeviceQueue(fused=False)`` (a step, then a burst) and
``ElasticDeviceQueue(fused=False)`` (bursts through a grow 4 -> 6 and a
shrink 6 -> 4) run in one forced-multi-device subprocess; the port runs
the same numpy waves on ``device="cpu"``.  Positions, matched flags,
dequeued values, ok and overflow flags, migration counts and the final
store (junk slot excluded: which duplicate write lands there is
unspecified) must be bit-identical; so must the port's seed wave and its
fused wave on the same waves.  The seed wave costs 5 exchanges a wave,
its bursts are sequential (``pipelined`` is forced off).
"""
import numpy as np
import pytest
import torch

from multidev import run_multidev

from repro_torch.dqueue import DeviceQueue, ElasticDeviceQueue

N, CAP, W, L, K = 4, 8, 2, 4, 3
KEYS = ("pos", "m", "dv", "dok", "ovf")
PLAN = [("burst",), ("grow", 2), ("burst",), ("shrink", [1, 4]),
        ("burst",)]


def _waves(nL, seed, k=4):
    rng = np.random.default_rng(seed)
    mixes = [0.3, 0.7, 0.7, 0.4][:k]       # wave 0 dequeues on an empty queue
    E = np.stack([rng.random(nL) < m for m in mixes])
    V = rng.random((k, nL)) < 0.85
    P = rng.integers(-2 ** 31, 2 ** 31, (k, nL, W), dtype=np.int64).astype(
        np.int32)
    return E, V, P


def _plan_waves():
    out, n = [], N
    for i, step in enumerate(PLAN):
        if step[0] == "grow":
            n += step[1]
        elif step[0] == "shrink":
            n -= len(step[1])
        else:
            out.append(_waves(n * L, seed=10 + i, k=K))
    return out


JAX_SCRIPT = r"""
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.dqueue import DeviceQueue, ElasticDeviceQueue
d = np.load(IN)
out = {}
q = DeviceQueue(make_mesh((4,), ("data",)), "data", cap=CAP,
                payload_width=W, ops_per_shard=L, fused=False)
assert not q.pipelined
st = q.init_state()
st, *o = q.step(st, jnp.asarray(d["E"][0]), jnp.asarray(d["V"][0]),
                jnp.asarray(d["P"][0]))
out.update({f"step_{k}": np.asarray(v) for k, v in zip(KEYS, o)})
st, *o = q.run_waves(st, jnp.asarray(d["E"][1:]), jnp.asarray(d["V"][1:]),
                     jnp.asarray(d["P"][1:]))
out.update({f"burst_{k}": np.asarray(v) for k, v in zip(KEYS, o)})
for k in ("first", "last", "store_vals", "store_full"):
    out[k] = np.asarray(getattr(st, k))
eq = ElasticDeviceQueue(4, cap=CAP, payload_width=W, ops_per_shard=L,
                        fused=False)
b, moved = 0, []
for step in PLAN:
    if step[0] == "grow":
        moved.append(eq.grow(step[1])["moved"])
    elif step[0] == "shrink":
        moved.append(eq.shrink(step[1])["moved"])
    else:
        o = eq.run_waves(*(jnp.asarray(d[f"{c}{b}"]) for c in "EVP"))
        out.update({f"e{b}_{k}": np.asarray(v) for k, v in zip(KEYS, o)})
        b += 1
out["moved"] = np.array(moved)
for k, v in eq._state_dict().items():
    out[f"e_{k}"] = np.asarray(v)
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seed_wave")
    E, V, P = _waves(N * L, seed=0)
    arrays = {"E": E, "V": V, "P": P}
    for b, (e, v, p) in enumerate(_plan_waves()):
        arrays.update({f"E{b}": e, f"V{b}": v, f"P{b}": p})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\n"
              f"OUT = {str(tmp / 'out.npz')!r}\nCAP, W, L = {CAP}, {W}, {L}\n"
              f"KEYS = {KEYS!r}\nPLAN = {PLAN!r}\n" + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _run(fused, pipelined=True):
    q = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                    fused=fused, pipelined=pipelined, device="cpu")
    E, V, P = (torch.from_numpy(x) for x in _waves(N * L, seed=0))
    st = q.init_state()
    x0 = q.runtime.n_exchanges
    st, *o = q.step(st, E[0], V[0], P[0])
    out = {"step_ex": q.runtime.n_exchanges - x0}
    out.update({f"step_{k}": v.numpy() for k, v in zip(KEYS, o)})
    x0 = q.runtime.n_exchanges
    st, *o = q.run_waves(st, E[1:], V[1:], P[1:])
    out["burst_ex"] = q.runtime.n_exchanges - x0
    out.update({f"burst_{k}": v.numpy() for k, v in zip(KEYS, o)})
    out.update({k: getattr(st, k).numpy() for k in
                ("first", "last", "store_vals", "store_full")})
    return q, out


def _assert_same(port, want, keys):
    for k in keys:
        a, b = port[k], want[k]
        if k.endswith("store_vals"):     # the junk slot is unspecified
            a, b = a[:, :CAP], b[:, :CAP]
        np.testing.assert_array_equal(a, b, err_msg=k)


STATE = ("first", "last", "store_vals", "store_full")
OUTS = [f"{p}_{k}" for p in ("step", "burst") for k in KEYS]


def test_seed_wave_matches_jax(jax_run):
    q, port = _run(fused=False)
    assert not q.pipelined and q.engine is None
    _assert_same(port, jax_run, OUTS + list(STATE))
    assert port["burst_dok"].any()              # dequeues found values
    assert port["step_ex"] == 5                 # five exchanges a wave
    assert port["burst_ex"] == 5 * 3


@pytest.mark.parametrize("pipelined", [True, False])
def test_seed_wave_matches_the_fused_wave(pipelined):
    _, seed = _run(fused=False)
    qf, fused = _run(fused=True, pipelined=pipelined)
    _assert_same(seed, fused, OUTS + list(STATE))
    assert fused["step_ex"] == 2
    assert fused["burst_ex"] == (3 + 1 if pipelined else 2 * 3)


def test_elastic_seed_wave_matches_jax(jax_run):
    eq = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                            fused=False, pool_size=8, device="cpu")
    assert not eq.inner.pipelined
    moved, b = [], 0
    for step in PLAN:
        if step[0] == "grow":
            moved.append(eq.grow(step[1])["moved"])
        elif step[0] == "shrink":
            moved.append(eq.shrink(step[1])["moved"])
        else:
            x0 = eq.runtime.n_exchanges
            o = eq.run_waves(*(torch.from_numpy(x)
                               for x in _plan_waves()[b]))
            assert eq.runtime.n_exchanges - x0 == 5 * K
            for k, v in zip(KEYS, o):
                np.testing.assert_array_equal(v.numpy(),
                                              jax_run[f"e{b}_{k}"])
            b += 1
    assert moved == jax_run["moved"].tolist()
    st = {k: v.numpy() for k, v in eq._state_dict().items()}
    _assert_same({f"e_{k}": v for k, v in st.items()}, jax_run,
                 [f"e_{k}" for k in STATE])
