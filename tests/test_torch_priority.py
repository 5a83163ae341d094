"""The port's P-tier priority queue against the JAX reference, bit for bit.

The tiered sweep: the same numpy inputs (out-of-range tiers and int32
wrap-around included) go through ``tiered_queue_scan_pallas(interpret=
True)`` and the port's ``tiered_queue_scan`` on CPU tensors (its plain
version).  ``priority_queue_scan`` strict and with relaxation 1 and 2
against ``repro.core.scan_queue.priority_queue_scan``.  The structures:
the JAX ``DevicePriorityQueue`` (4 shards, pipelined and sequential) and
``ElasticDevicePriorityQueue`` (4 -> 6 -> 3 -> 5 shards, strict and
relaxation 1) run in one forced-multi-device subprocess that writes an
``.npz``; the port runs the same waves on ``device="cpu"``.  Tiers,
positions, matched flags, dequeued values, ok and overflow flags,
``n_relaxed``, migration ``moved`` and hash balance, and the final store
(junk slot excluded) must be equal.  At 300 tiers, more than one launch
of the port's tiered kernel takes, the JAX ``DevicePriorityQueue`` runs
its fused Pallas sweep (interpret mode) and the port's
``DevicePriorityQueue`` and ``ElasticDevicePriorityQueue`` the same
waves.  Also: the port's host oracle
``repro_torch.core.priority.PriorityOracle`` op by op through JOIN/LEAVE
(beside the reference's ``repro.core.priority.PriorityOracle`` on the same
waves, record for record), a JAX
final state continued in the port, and the per-tier overflow error.  All
outputs are integers: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from multidev import run_multidev
from repro.core.priority import PriorityOracle as RefPriorityOracle
from repro.core.scan_queue import priority_queue_scan as _j_pq_scan
from repro.core.scan_queue import strict_batch_deletemin as j_deletemin
from repro.kernels.segscan import (priority_queue_scan_pallas,
                                   tiered_queue_scan_pallas)

from repro_torch.core.priority import DEQ, ENQ, PriorityOracle
from repro_torch.core.scan_queue import (priority_queue_scan,
                                         strict_batch_deletemin)
from repro_torch.dqueue import (DevicePriorityQueue,
                                ElasticDevicePriorityQueue,
                                QueueOverflowError)
from repro_torch.interop import state_from_jax, state_to_numpy
from repro_torch.kernels.segscan import (make_tier_scan,
                                         priority_queue_scan_fused,
                                         tiered_queue_scan,
                                         tiered_queue_scan_ref)

j_pq_scan = jax.jit(_j_pq_scan, static_argnames=("n_prios", "relaxation",
                                                 "n_shards"))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tier_case(n, P, seed):
    """Enqueue flags, tiers in [-2, P + 2) (out-of-range ones included),
    and per-tier windows, some empty and one near the int32 edge."""
    rng = np.random.default_rng(seed)
    enq = rng.random(n) < 0.7
    tier = rng.integers(-2, P + 2, n).astype(np.int32)
    firsts = rng.integers(0, 1000, P).astype(np.int32)
    lasts = (firsts + rng.integers(-1, 500, P)).astype(np.int32)
    lasts[0] = 2 ** 31 - 10          # the sweep wraps like int32 sums do
    return enq, tier, firsts, lasts


@pytest.mark.parametrize("n,P", [(1500, 4), (1024, 8), (2049, 1), (1, 3)])
def test_tiered_scan_matches_pallas_interpret(n, P):
    enq, tier, firsts, lasts = _tier_case(n, P, seed=n + P)
    jp, jl = tiered_queue_scan_pallas(jnp.asarray(enq), jnp.asarray(tier),
                                      jnp.asarray(firsts), jnp.asarray(lasts),
                                      P, interpret=True)
    tp, tl = tiered_queue_scan(_t(enq), _t(tier), _t(firsts), _t(lasts), P)
    assert tp.dtype == tl.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tp.numpy()[~enq] == -1).all()
    assert (tp.numpy()[(tier < 0) | (tier >= P)] == -1).all()


@pytest.mark.parametrize("P", [16, 64])
def test_tiered_scan_matches_the_per_tier_loop(P):
    # the reference's oracle for the hook: one masked FIFO scan per tier,
    # in JAX at 16 tiers and in the port's own copy of it at 64 (the JAX
    # compile of 64 unrolled scans alone takes half a minute)
    enq, tier, firsts, lasts = _tier_case(3000, P, seed=5)
    lasts[0] = firsts[0] + 3
    valid = np.ones(3000, bool)
    got = priority_queue_scan(_t(enq), _t(tier), _t(valid), _t(firsts),
                              _t(lasts), n_prios=P,
                              tier_scan=make_tier_scan(P))
    if P <= 16:
        want = j_pq_scan(jnp.asarray(enq), jnp.asarray(tier),
                         jnp.asarray(valid), jnp.asarray(firsts),
                         jnp.asarray(lasts), n_prios=P)
    else:
        want = [x.numpy() for x in priority_queue_scan(
            _t(enq), _t(tier), _t(valid), _t(firsts), _t(lasts), n_prios=P)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tiered_scan_is_plain_on_cpu_tensors():
    enq, tier, firsts, lasts = _tier_case(700, 4, seed=9)
    before = tiered_queue_scan.launches
    out = tiered_queue_scan(_t(enq), _t(tier), _t(firsts), _t(lasts), 4)
    assert tiered_queue_scan.launches == before     # the kernel never ran
    for a, b in zip(out, tiered_queue_scan_ref(_t(enq), _t(tier),
                                               _t(lasts))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tiered_queue_scan(_t(enq), _t(tier), _t(firsts), _t(lasts), 5)


def _pq_case(n, P, seed, n_shards=8):
    rng = np.random.default_rng(seed)
    e = rng.random(n) < 0.5
    v = rng.random(n) < 0.9
    pr = rng.integers(-1, P + 1, n).astype(np.int32)
    f = rng.integers(0, 50, P).astype(np.int32)
    last = (f + rng.integers(-1, 40, P)).astype(np.int32)
    so = (np.arange(n) // (n // n_shards)).astype(np.int32)
    return e, v, pr, f, last, so


@pytest.mark.parametrize("relaxation", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("hook", [False, True])
def test_priority_queue_scan_matches_jax(relaxation, P, hook):
    e, v, pr, f, last, so = _pq_case(512, P, seed=10 * P + relaxation)
    want = j_pq_scan(jnp.asarray(e), jnp.asarray(pr), jnp.asarray(v),
                     jnp.asarray(f), jnp.asarray(last), n_prios=P,
                     relaxation=relaxation, shard_of=jnp.asarray(so),
                     n_shards=8)
    got = priority_queue_scan(_t(e), _t(pr), _t(v), _t(f), _t(last),
                              n_prios=P, relaxation=relaxation,
                              shard_of=_t(so), n_shards=8,
                              tier_scan=make_tier_scan(P) if hook else None)
    for a, b in zip(got, want):
        assert a.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if relaxation and P > 1:
        assert int(got[5]) > 0                 # some serve was relaxed


def test_priority_scan_fused_matches_pallas_interpret():
    e, v, pr, f, last, _ = _pq_case(1500, 4, seed=3)
    want = priority_queue_scan_pallas(jnp.asarray(e), jnp.asarray(pr),
                                      jnp.asarray(v), jnp.asarray(f),
                                      jnp.asarray(last), 4, interpret=True)
    got = priority_queue_scan_fused(_t(e), _t(pr), _t(v), _t(f), _t(last), 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_strict_batch_deletemin_matches_jax():
    rng = np.random.default_rng(12)
    deq = rng.random(400) < 0.6
    avail = np.array([5, 0, 100, 7], np.int32)
    firsts = np.array([3, 9, -4, 1_000_000], np.int32)
    want = j_deletemin(jnp.asarray(deq), jnp.asarray(avail),
                       jnp.asarray(firsts), 4)
    got = strict_batch_deletemin(_t(deq), _t(avail), _t(firsts), 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ structures --------
N, P_, CAP, W, L, K = 4, 4, 8, 2, 4, 3
KEYS = ("tier", "pos", "m", "dv", "dok", "ovf", "nrel")
PLAN = [("burst", 0.7), ("burst", 0.7), ("grow", 2), ("burst", 0.5),
        ("shrink", [0, 2, 4]), ("burst", 0.6), ("grow", 2), ("burst", 0.2)]
EXTRA_MIX = 0.5
RELAX = (0, 1)


def _bursts(seed=0):
    """One (E, V, PR, PW) per burst of PLAN plus the extra burst; payload
    word 0 is the op's global id, tiers skewed toward the urgent end."""
    rng = np.random.default_rng(seed)
    n_shards, out, op_id = N, [], 0
    for action, arg in PLAN + [("burst", EXTRA_MIX)]:
        if action == "grow":
            n_shards += arg
        elif action == "shrink":
            n_shards -= len(arg)
        else:
            nL = n_shards * L
            E = rng.random((K, nL)) < arg
            V = rng.random((K, nL)) < 0.9
            PR = rng.choice(P_, (K, nL), p=[0.4, 0.3, 0.2, 0.1]).astype(
                np.int32)
            PW = np.zeros((K, nL, W), np.int32)
            PW[..., 0] = np.arange(op_id, op_id + K * nL).reshape(K, nL)
            PW[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (K, nL),
                                      dtype=np.int64).astype(np.int32)
            op_id += K * nL
            out.append((E, V, PR, PW))
    return out


JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dqueue import DevicePriorityQueue, ElasticDevicePriorityQueue
d = np.load(IN, allow_pickle=False)
out = {}
def arrs(b, k=None):
    xs = [d[f"{c}{b}"] for c in ("E", "V", "PR", "PW")]
    return [jnp.asarray(x if k is None else x[k]) for x in xs]
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
for name, pipelined in (("pipe", True), ("seq", False)):
    q = DevicePriorityQueue(mesh, "data", n_prios=4, cap=8, payload_width=2,
                            ops_per_shard=4, relaxation=1,
                            pipelined=pipelined)
    st = q.init_state()
    st, *o = q.step(st, *arrs(0, 0))
    for k, v in zip(KEYS, o):
        out[f"{name}_step_{k}"] = np.asarray(v)
    st, *o = q.run_waves(st, *arrs(1))
    for k, v in zip(KEYS, o):
        out[f"{name}_burst_{k}"] = np.asarray(v)
    for k in ("firsts", "lasts", "store_vals", "store_full"):
        out[f"{name}_{k}"] = np.asarray(getattr(st, k))
for relax in RELAX:
    eq = ElasticDevicePriorityQueue(4, n_prios=4, relaxation=relax, cap=8,
                                    payload_width=2, ops_per_shard=4)
    b, mig = 0, 0
    for action, arg in PLAN:
        if action == "burst":
            for k, v in zip(KEYS, eq.run_waves(*arrs(b))):
                out[f"r{relax}_b{b}_{k}"] = np.asarray(v)
            b += 1
            continue
        st = eq.grow(arg) if action == "grow" else eq.shrink(arg)
        hb = st["hash_balance"]
        out[f"r{relax}_mig{mig}"] = np.array(
            [st["moved"], eq.size, hb["n"], hb["max"], hb["min"],
             hb["roundrobin_max"], st["P_to"]] + list(eq.sizes))
        mig += 1
    for k, v in eq._state_dict().items():
        out[f"r{relax}_final_{k}"] = np.asarray(v)
    for k, v in zip(KEYS, eq.run_waves(*arrs(b))):
        out[f"r{relax}_x_{k}"] = np.asarray(v)
    for k, v in eq._state_dict().items():
        out[f"r{relax}_after_{k}"] = np.asarray(v)
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("priority")
    arrays = {}
    for i, bt in enumerate(_bursts()):
        arrays.update({f"{c}{i}": x for c, x in zip(("E", "V", "PR", "PW"),
                                                    bt)})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              f"PLAN = {PLAN!r}\nKEYS = {KEYS!r}\nRELAX = {RELAX!r}\n"
              + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _assert_store_equal(port: dict, jax_run: dict, prefix: str):
    junk = P_ * CAP
    for k in ("firsts", "lasts"):
        np.testing.assert_array_equal(port[k], jax_run[f"{prefix}_{k}"])
    # the junk slot is excluded: which duplicate write lands there is
    # unspecified
    np.testing.assert_array_equal(port["store_vals"][:, :junk],
                                  jax_run[f"{prefix}_store_vals"][:, :junk])
    np.testing.assert_array_equal(port["store_full"],
                                  jax_run[f"{prefix}_store_full"])


def _device_pq_run(pipelined):
    q = DevicePriorityQueue(N, n_prios=P_, cap=CAP, payload_width=W,
                            ops_per_shard=L, relaxation=1,
                            pipelined=pipelined, device="cpu")
    b0, b1 = ([_t(x) for x in b] for b in _bursts()[:2])
    out = {}
    st = q.init_state()
    x0 = q.runtime.n_exchanges
    st, *o = q.step(st, *(x[0] for x in b0))
    out["step_ex"] = q.runtime.n_exchanges - x0
    out.update({f"step_{k}": v.numpy() for k, v in zip(KEYS, o)})
    x0 = q.runtime.n_exchanges
    st, *o = q.run_waves(st, *b1)
    out["burst_ex"] = q.runtime.n_exchanges - x0
    out.update({f"burst_{k}": v.numpy() for k, v in zip(KEYS, o)})
    out.update(state_to_numpy(st))
    return out


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_priority_queue_matches_jax(jax_run, pipelined):
    name = "pipe" if pipelined else "seq"
    port = _device_pq_run(pipelined)
    for k in [f"{p}_{k}" for p in ("step", "burst") for k in KEYS]:
        np.testing.assert_array_equal(port[k], jax_run[f"{name}_{k}"],
                                      err_msg=k)
    _assert_store_equal(port, jax_run, name)
    assert port["step_ex"] == 2
    assert port["burst_ex"] == (K + 1 if pipelined else 2 * K)
    assert port["burst_nrel"].shape == (K,)


def _burst(eq, E, V, PR, PW):
    o = eq.run_waves(_t(E), _t(V), _t(PR), _t(PW))
    return {k: v.numpy() for k, v in zip(KEYS, o)}


@pytest.fixture(scope="module")
def port_runs():
    runs = {}
    bursts = _bursts()
    for relax in RELAX:
        eq = ElasticDevicePriorityQueue(N, n_prios=P_, relaxation=relax,
                                        cap=CAP, payload_width=W,
                                        ops_per_shard=L, pool_size=8,
                                        device="cpu")
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
            migs.append((st, eq.size, eq.sizes))
        runs[relax] = (eq, out, migs)
    return runs


@pytest.mark.parametrize("relax", RELAX)
def test_elastic_priority_matches_jax_through_join_and_leave(
        jax_run, port_runs, relax):
    eq, out, _ = port_runs[relax]
    n_bursts = sum(a == "burst" for a, _ in PLAN)
    for b in range(n_bursts):
        for k in KEYS:
            np.testing.assert_array_equal(out[f"b{b}_{k}"],
                                          jax_run[f"r{relax}_b{b}_{k}"],
                                          err_msg=f"burst {b} {k}")
    assert eq.n_shards == 5 and len(eq.migrations) == 3
    _assert_store_equal(state_to_numpy(eq.state), jax_run, f"r{relax}_final")
    assert any(out[f"b{b}_dok"].any() for b in range(n_bursts))
    E, V, _, _ = _bursts()[n_bursts - 1]
    assert (V & ~E & ~out[f"b{n_bursts - 1}_m"]).any()      # ⊥ dequeues
    n_relaxed = sum(int(out[f"b{b}_nrel"].sum()) for b in range(n_bursts))
    assert (n_relaxed > 0) == (relax > 0)


@pytest.mark.parametrize("relax", RELAX)
def test_elastic_priority_migrations_match_jax(jax_run, port_runs, relax):
    eq, _, migs = port_runs[relax]
    for i, (st, size, sizes) in enumerate(migs):
        want = [int(x) for x in jax_run[f"r{relax}_mig{i}"]]
        moved, jsize, n, mx, mn, rr, P_to = want[:7]
        assert st["moved"] == moved == size == jsize
        assert sizes == want[7:]
        assert st["P_to"] == P_to
        hb = st["hash_balance"]
        assert (hb["n"], hb["max"], hb["min"], hb["roundrobin_max"]) == (
            n, mx, mn, rr)
        assert sum(hb["counts"]) == hb["n"] and len(hb["counts"]) == P_to
    assert eq.window_capacity() == eq.n_shards * CAP
    pr = eq.pressure()
    assert pr["n_windows"] == P_ and pr["occupancy"] == eq.sizes


@pytest.mark.parametrize("relax", RELAX)
def test_continue_from_jax_priority_state(jax_run, relax):
    bursts = _bursts()
    pre = f"r{relax}_final_"
    d = {k[len(pre):]: v for k, v in jax_run.items() if k.startswith(pre)}
    eq = ElasticDevicePriorityQueue(5, n_prios=P_, relaxation=relax,
                                    cap=CAP, payload_width=W,
                                    ops_per_shard=L, pool_size=8,
                                    device="cpu")
    eq.state = state_from_jax(d, "cpu")
    got = _burst(eq, *bursts[-1])
    for k in KEYS:
        np.testing.assert_array_equal(got[k], jax_run[f"r{relax}_x_{k}"],
                                      err_msg=k)
    _assert_store_equal(state_to_numpy(eq.state), jax_run, f"r{relax}_after")


@pytest.mark.parametrize("relax", RELAX)
@pytest.mark.parametrize("n_prios", [2, 4])
def test_elastic_priority_matches_oracle(relax, n_prios):
    eq = ElasticDevicePriorityQueue(4, n_prios=n_prios, relaxation=relax,
                                    cap=32, payload_width=2, ops_per_shard=4,
                                    pool_size=8, device="cpu")
    oracle = PriorityOracle(n_prios, relaxation=relax)
    ref_oracle = RefPriorityOracle(n_prios, relaxation=relax)
    rng = np.random.default_rng(100 * n_prios + relax)
    relaxed = 0
    for it in range(14):
        if it == 5:
            assert eq.grow(2)["moved"] == eq.size == oracle.size
        if it == 10:
            assert eq.shrink([0, 3])["moved"] == eq.size == oracle.size
        n = eq.n_shards * eq.L
        e, v = rng.random(n) < 0.55, rng.random(n) < 0.9
        pr = rng.integers(0, n_prios, n).astype(np.int32)
        pw = np.zeros((n, 2), np.int32)
        pw[:, 0] = rng.integers(0, 1 << 20, n)
        tier, pos, m, dv, dok, ovf, nrel = (
            x.numpy() for x in eq.step(e, v, pr, pw))
        assert not ovf
        ops = [None if not v[i] else
               ((ENQ, int(pr[i]), int(pw[i, 0]), i // eq.L) if e[i]
                else (DEQ, 0, None, i // eq.L)) for i in range(n)]
        recs = oracle.wave(ops, n_shards=eq.n_shards)
        assert [vars(r) for r in recs] == [
            vars(r) for r in ref_oracle.wave(ops, n_shards=eq.n_shards)]
        for i, r in enumerate(recs):
            assert (bool(m[i]), int(tier[i]), int(pos[i])) == (
                r.matched, r.tier, r.pos), (it, i)
            if r.matched and r.value is not None:
                assert dok[i] and int(dv[i, 0]) == r.value, (it, i)
        assert int(nrel) == sum(r.relaxed for r in recs)
        relaxed += int(nrel)
    assert eq.sizes == oracle.sizes
    assert (relaxed > 0) == (relax > 0 and n_prios > 1)


def test_tier_overflow_raises_with_per_tier_occupancy():
    eq = ElasticDevicePriorityQueue(2, n_prios=2, cap=2, payload_width=1,
                                    ops_per_shard=2, device="cpu")
    full = np.ones((1, 4), bool)
    eq.run_waves(full, full, np.ones((1, 4), np.int32),
                 np.zeros((1, 4, 1), np.int32))
    assert eq.sizes == [0, 4] and eq.headroom() == [4, 0]
    one = np.array([[True, False, False, False]])
    with pytest.raises(QueueOverflowError) as err:
        eq.run_waves(one, one, np.ones((1, 4), np.int32),
                     np.zeros((1, 4, 1), np.int32))
    assert err.value.kind == "pqueue" and err.value.capacity == 4
    assert err.value.occupancy == [0, 5] and err.value.wave == 0


# ------------------------------------------------- more than 256 tiers ----
P300, CAP300, B300 = 300, 8, 3

P300_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dqueue import DevicePriorityQueue
d = np.load(IN, allow_pickle=False)
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
# the fused sweep (grid tiers x tiles): the jnp loop's 300 masked scans
# take minutes to compile on the CPU
q = DevicePriorityQueue(mesh, "data", n_prios=P, cap=CAP, payload_width=2,
                        ops_per_shard=4, fused_dispatch=True)
st = q.init_state()
out = {}
for b in range(B):
    st, *o = q.run_waves(st, *(jnp.asarray(d[f"{c}{b}"])
                               for c in ("E", "V", "PR", "PW")))
    for k, v in zip(KEYS, o):
        out[f"b{b}_{k}"] = np.asarray(v)
for k in ("firsts", "lasts", "store_vals", "store_full"):
    out[k] = np.asarray(getattr(st, k))
np.savez(OUT, **out)
print("ok")
"""


def _bursts_300():
    """B300 bursts of K waves on 4 shards x 4 ops; tiers over all 300 (a
    quarter of the enqueues past tier 255), payload word 0 the op id."""
    rng = np.random.default_rng(300)
    nL, out = N * L, []
    for b in range(B300):
        E = rng.random((K, nL)) < (0.8 if b < 2 else 0.3)
        V = rng.random((K, nL)) < 0.9
        PR = np.where(rng.random((K, nL)) < 0.25,
                      rng.integers(256, P300, (K, nL)),
                      rng.integers(0, 256, (K, nL))).astype(np.int32)
        PW = np.zeros((K, nL, W), np.int32)
        PW[..., 0] = np.arange(b * K * nL, (b + 1) * K * nL).reshape(K, nL)
        out.append((E, V, PR, PW))
    return out


@pytest.fixture(scope="module")
def jax_run_300(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("priority300")
    arrays = {f"{c}{b}": x for b, bt in enumerate(_bursts_300())
              for c, x in zip(("E", "V", "PR", "PW"), bt)}
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              f"P = {P300}\nCAP = {CAP300}\nB = {B300}\nKEYS = {KEYS!r}\n"
              + P300_SCRIPT)
    run_multidev(script, n_dev=4, timeout=600)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("elastic", [False, True])
def test_priority_queue_300_tiers_matches_jax(jax_run_300, elastic):
    kw = dict(n_prios=P300, cap=CAP300, payload_width=W, ops_per_shard=L,
              device="cpu")
    if elastic:
        q = ElasticDevicePriorityQueue(N, **kw)
        outs = [_burst(q, *bt) for bt in _bursts_300()]
        final = state_to_numpy(q.state)
    else:
        q = DevicePriorityQueue(N, **kw)
        st, outs = q.init_state(), []
        for bt in _bursts_300():
            st, *o = q.run_waves(st, *(_t(x) for x in bt))
            outs.append({k: v.numpy() for k, v in zip(KEYS, o)})
        final = state_to_numpy(st)
    for b, out in enumerate(outs):
        for k in KEYS:
            np.testing.assert_array_equal(out[k], jax_run_300[f"b{b}_{k}"],
                                          err_msg=f"burst {b} {k}")
    junk = P300 * CAP300
    for k in ("firsts", "lasts", "store_full"):
        np.testing.assert_array_equal(final[k], jax_run_300[k])
    np.testing.assert_array_equal(final["store_vals"][:, :junk],
                                  jax_run_300["store_vals"][:, :junk])
    placed = np.concatenate([o["tier"].reshape(-1) for o in outs])
    assert (placed >= 256).any() and outs[-1]["dok"].any()
