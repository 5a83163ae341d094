"""The port's wave engine and FIFO DeviceQueue against the JAX reference.

The JAX ``DeviceQueue`` runs on a forced 4-device CPU mesh in one
subprocess (``multidev.run_multidev``) and writes its outputs to an
``.npz``; the port runs the same numpy waves on ``device="cpu"``.
Positions, matched flags, dequeued values, ok flags, overflow flags and
the final store (junk row excluded: which duplicate write lands there is
unspecified) must be bit-identical.  Also: step against run_waves,
sequential against pipelined, the exchange budget (2 per step, K+1 per
pipelined burst, 2K per sequential burst), and the host-side helpers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from multidev import run_multidev
from repro.dqueue import wave_engine as jwe

from repro_torch.dqueue import DeviceQueue
from repro_torch.dqueue import wave_engine as twe

N, CAP, W, L = 4, 8, 2, 4
NL = N * L


def _waves(seed=0):
    rng = np.random.default_rng(seed)
    mixes = [0.3, 0.7, 0.7, 0.4]           # wave 0 dequeues on an empty queue
    E = np.stack([rng.random(NL) < m for m in mixes])
    V = rng.random((4, NL)) < 0.85
    P = np.arange(4 * NL * W, dtype=np.int32).reshape(4, NL, W)
    return E, V, P


JAX_SCRIPT = r"""
import numpy as np, jax.numpy as jnp
from repro.compat import make_mesh
from repro.dqueue import DeviceQueue
d = np.load(IN)
mesh = make_mesh((4,), ("data",))
out = {}
for name, pipelined in (("pipe", True), ("seq", False)):
    q = DeviceQueue(mesh, "data", cap=8, payload_width=2, ops_per_shard=4,
                    pipelined=pipelined)
    st = q.init_state()
    st, *o = q.step(st, jnp.asarray(d["E"][0]), jnp.asarray(d["V"][0]),
                    jnp.asarray(d["P"][0]))
    for k, v in zip(("pos", "m", "dv", "dok", "ovf"), o):
        out[f"{name}_step_{k}"] = np.asarray(v)
    st, *o = q.run_waves(st, jnp.asarray(d["E"][1:]), jnp.asarray(d["V"][1:]),
                         jnp.asarray(d["P"][1:]))
    for k, v in zip(("pos", "m", "dv", "dok", "ovf"), o):
        out[f"{name}_burst_{k}"] = np.asarray(v)
    for k in ("first", "last", "store_vals", "store_full"):
        out[f"{name}_{k}"] = np.asarray(getattr(st, k))
np.savez(OUT, **out)
print("ok")
"""

KEYS = ("pos", "m", "dv", "dok", "ovf")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wave_engine")
    E, V, P = _waves()
    np.savez(tmp / "in.npz", E=E, V=V, P=P)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              + JAX_SCRIPT)
    run_multidev(script, n_dev=4, timeout=300)
    return dict(np.load(tmp / "out.npz"))


def _port(pipelined):
    q = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                    pipelined=pipelined, device="cpu")
    E, V, P = (torch.from_numpy(x) for x in _waves())
    out = {}
    st = q.init_state()
    x0 = q.runtime.n_exchanges
    st, *o = q.step(st, E[0], V[0], P[0])
    out["step_ex"] = q.runtime.n_exchanges - x0
    out.update({f"step_{k}": v.numpy() for k, v in zip(KEYS, o)})
    x0 = q.runtime.n_exchanges
    st, *o = q.run_waves(st, E[1:], V[1:], P[1:])
    out["burst_ex"] = q.runtime.n_exchanges - x0
    out.update({f"burst_{k}": v.numpy() for k, v in zip(KEYS, o)})
    out.update({k: getattr(st, k).numpy()
                for k in ("first", "last", "store_vals", "store_full")})
    return out


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_queue_matches_jax(jax_run, pipelined):
    name = "pipe" if pipelined else "seq"
    port = _port(pipelined)
    for k in [f"{p}_{k}" for p in ("step", "burst") for k in KEYS]:
        np.testing.assert_array_equal(port[k], jax_run[f"{name}_{k}"],
                                      err_msg=k)
    assert int(port["first"]) == int(jax_run[f"{name}_first"])
    assert int(port["last"]) == int(jax_run[f"{name}_last"])
    np.testing.assert_array_equal(port["store_vals"][:, :CAP],
                                  jax_run[f"{name}_store_vals"][:, :CAP])
    np.testing.assert_array_equal(port["store_full"],
                                  jax_run[f"{name}_store_full"])
    assert not port["store_full"][:, CAP].any()
    # the waves really had unmatched dequeues (⊥) and matched ones
    E, V, _ = _waves()
    assert (V[0] & ~E[0] & ~port["step_m"]).any()
    assert port["burst_dok"].any()


def test_exchange_budget_and_schedules_agree():
    pipe, seq = _port(True), _port(False)
    assert pipe["step_ex"] == seq["step_ex"] == 2
    K = 3
    assert pipe["burst_ex"] == K + 1
    assert seq["burst_ex"] == 2 * K
    for k in pipe:
        if not k.endswith("_ex") and k != "store_vals":
            np.testing.assert_array_equal(pipe[k], seq[k], err_msg=k)
    np.testing.assert_array_equal(pipe["store_vals"][:, :CAP],
                                  seq["store_vals"][:, :CAP])


def test_step_loop_equals_run_waves():
    E, V, P = (torch.from_numpy(x) for x in _waves(seed=5))
    q = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                    device="cpu")
    st = q.init_state()
    steps = []
    for k in range(E.shape[0]):
        st, *o = q.step(st, E[k], V[k], P[k])
        steps.append(o)
    st2 = q.init_state()
    st2, *burst = q.run_waves(st2, E, V, P)
    for i, col in enumerate(burst):
        assert torch.equal(col, torch.stack([s[i] for s in steps]))
    assert (int(st.first), int(st.last)) == (int(st2.first), int(st2.last))
    assert torch.equal(st.store_full, st2.store_full)


@pytest.mark.parametrize("L_", [1, 2, 3, 4, 7, 64, 1024])
def test_bucket_ladder_and_pick_width_match_jax(L_):
    assert twe.bucket_ladder(L_) == jwe.bucket_ladder(L_)
    for n_shards in (1, 3, 8):
        for n_ops in (0, 1, L_, n_shards * L_ // 3, n_shards * L_,
                      n_shards * L_ + 1):
            assert (twe.pick_bucket_width(L_, n_shards, n_ops)
                    == jwe.pick_bucket_width(L_, n_shards, n_ops))


@pytest.mark.parametrize("new_last", [30, 31, 32])
def test_post_enqueue_peak_overflow_at_exact_capacity(new_last):
    # first = 0, capacity 32: last = 31 is exactly full, 32 wraps
    got = twe.post_enqueue_peak_overflow(torch.tensor(0, dtype=torch.int32),
                                         torch.tensor(new_last,
                                                      dtype=torch.int32), 32)
    want = jwe.post_enqueue_peak_overflow(jnp.int32(0), jnp.int32(new_last),
                                          32)
    assert bool(got) == bool(want) == (new_last >= 32)


def test_wave_overflow_flag_at_exact_capacity():
    q = DeviceQueue(2, cap=2, payload_width=1, ops_per_shard=2, device="cpu")
    st = q.init_state()
    full = torch.ones(4, dtype=torch.bool)
    st, *o = q.step(st, full, full, torch.zeros(4, 1, dtype=torch.int32))
    assert not bool(o[-1]) and int(st.last) == 3       # exactly full: fine
    one = torch.tensor([True, False, False, False])
    st, *o = q.step(st, one, one, torch.zeros(4, 1, dtype=torch.int32))
    assert bool(o[-1])                                 # wrap-around flagged


def test_migration_helpers_match_jax():
    rng = np.random.default_rng(11)
    # recover_positions with negative (s - first): floor semantics
    for P_old, cap, first in ((4, 8, 0), (6, 5, 13), (3, 32, 1_000_001)):
        s = np.arange(P_old, dtype=np.int32)[:, None]
        t = np.arange(cap, dtype=np.int32)[None, :]
        want = np.asarray(jwe.recover_positions(jnp.asarray(s), jnp.asarray(t),
                                                jnp.int32(first), P_old, cap))
        got = twe.recover_positions(torch.from_numpy(s), torch.from_numpy(t),
                                    torch.tensor(first, dtype=torch.int32),
                                    P_old, cap)
        np.testing.assert_array_equal(got.numpy(), want)
    for P_old, P_new, cap in ((4, 6, 32), (64, 48, 65536), (5, 3, 7)):
        assert (twe.fanout_bound(P_old, P_new, cap)
                == jwe.fanout_bound(P_old, P_new, cap))
        assert twe.fanout_bound(P_old, P_new, cap) <= cap
    # dest_rank: per source row, the reference's one-hot cumsum rank
    owner = rng.integers(0, 5, (3, 40)).astype(np.int32)
    live = rng.random((3, 40)) < 0.7
    got = twe.dest_rank(torch.from_numpy(owner), torch.from_numpy(live), 5)
    for r in range(3):
        want = np.asarray(jwe.dest_rank(jnp.asarray(owner[r]),
                                        jnp.asarray(live[r]), 5))
        np.testing.assert_array_equal(got[r].numpy()[live[r]],
                                      want[live[r]])



@pytest.mark.parametrize("K", [1, 4])
def test_pipelined_burst_carries_aux_like_sequential(K):
    # the priority discipline has one aux output (n_relaxed); the
    # pipelined schedule primes its in-flight aux with zero_aux and must
    # return the same [K] vector as the sequential one
    from repro_torch.dqueue import DevicePriorityQueue, PriorityDiscipline
    assert PriorityDiscipline.n_aux == 1 and twe.Discipline.n_aux == 0
    rng = np.random.default_rng(K)
    n, P = N * L, 3
    E = torch.from_numpy(np.concatenate([np.ones((1, n), bool),
                                         rng.random((K, n)) < 0.3]))
    V = torch.ones(K + 1, n, dtype=torch.bool)
    PR = torch.from_numpy(rng.integers(0, P, (K + 1, n)).astype(np.int32))
    PW = torch.zeros(K + 1, n, W, dtype=torch.int32)
    outs = []
    for pipelined in (True, False):
        q = DevicePriorityQueue(N, n_prios=P, cap=CAP, payload_width=W,
                                ops_per_shard=L, relaxation=1,
                                pipelined=pipelined, device="cpu")
        st, *_ = q.step(q.init_state(), E[0], V[0], PR[0], PW[0])
        st, *o = q.run_waves(st, E[1:], V[1:], PR[1:], PW[1:])
        assert len(o) == 7 and o[-1].shape == (K,)
        assert o[-1].dtype == torch.int32
        outs.append(o)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][-1].sum()) > 0          # some serve was relaxed
