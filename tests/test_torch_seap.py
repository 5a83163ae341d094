"""The port's Seap arbitrary-key queue against the JAX reference, bit for bit.

The scan: the same numpy inputs (keys at ``INT32_MIN``/``INT32_MAX``
included) go through ``repro.core.scan_queue.seap_bucket_lookup`` and
``seap_queue_scan`` and the port's counterparts on CPU tensors, over
several waves that split and merge the directory, with the per-bucket
loop (``tier_scan=None``) and with the tiered sweep hook (the port's
``make_tier_scan``, the reference's Pallas sweep in interpret mode), at
1, 8 and 300 buckets (300 take two groups of the tiered kernel).  The
reference's int32-edge cases are mirrored on the port: the midpoint
against an int64 floor, the split boundary at both edges, a single-key
bucket that never splits again, and parity with the host oracle.

The structures: the JAX ``DeviceSeapQueue`` (4 shards, pipelined and
sequential) and ``ElasticDeviceSeapQueue`` (4 -> 6 -> 3 -> 5 shards, cold
and seeded) run in one forced-multi-device subprocess that writes an
``.npz``; the port runs the same waves on ``device="cpu"``.  Buckets,
positions, matched flags, dequeued values, ok and overflow flags,
``n_active``, migration ``moved`` and hash balance, and the final
8-field state (junk slot excluded) must be equal.  Also: the port's host oracle
``repro_torch.core.seap.SeapOracle`` op by op through JOIN/LEAVE (beside
the reference's ``repro.core.seap.SeapOracle`` on the same waves, record
for record), a JAX final
state continued in the port, the per-bucket overflow error, seed
validation, and the CUDA default.  Every output is an integer: the
tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from multidev import run_multidev
from repro.core.scan_queue import seap_bucket_lookup as j_lookup
from repro.core.scan_queue import seap_queue_scan as j_seap_scan
from repro.core.seap import SeapOracle as RefSeapOracle
from repro.kernels.segscan import make_tier_scan as j_make_tier_scan

from repro_torch.core.scan_queue import seap_bucket_lookup, seap_queue_scan
from repro_torch.core.seap import DEQ, ENQ, SeapOracle, check_seed_bounds
from repro_torch.dqueue import (DeviceSeapQueue, ElasticDeviceSeapQueue,
                                PriorityQueueState, QueueOverflowError,
                                SeapQueueState)
from repro_torch.interop import state_from_jax, state_to_numpy
from repro_torch.kernels.segscan import make_tier_scan, tiered_queue_scan

I32MIN, I32MAX = -(2 ** 31), 2 ** 31 - 1


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _directory(B, rng, n_active):
    """A directory with ``n_active`` active buckets at random ids: the
    root at INT32_MIN, distinct boundaries, INT32_MAX one of them when
    there is room; inactive buckets at INT32_MAX and empty."""
    lo = np.full(B, I32MAX, np.int32)
    active = np.zeros(B, bool)
    active[0] = True
    lo[0] = I32MIN
    ids = rng.choice(np.arange(1, B), n_active - 1, replace=False)
    bounds = np.sort(rng.choice(np.arange(-5000, 5000), n_active - 1,
                                replace=False))
    if n_active > 2:
        bounds[-1] = I32MAX
    lo[ids], active[ids] = bounds, True
    return lo, active


def _keys(n, rng):
    """Keys around zero with clusters at both int32 edges."""
    key = rng.integers(-6000, 6000, n).astype(np.int64)
    edge = rng.random(n)
    key[edge < 0.1] = I32MIN + rng.integers(0, 3, int((edge < 0.1).sum()))
    key[edge > 0.9] = I32MAX - rng.integers(0, 3, int((edge > 0.9).sum()))
    return key.astype(np.int32)


@pytest.mark.parametrize("B", [1, 8, 300])
def test_bucket_lookup_matches_jax(B):
    rng = np.random.default_rng(B)
    for n_active in sorted({1, max(1, B // 2), B}):
        lo, active = _directory(B, rng, n_active)
        key = _keys(3000, rng)
        want = np.asarray(j_lookup(jnp.asarray(key), jnp.asarray(lo),
                                   jnp.asarray(active)))
        # numpy's int64 keys are cast on entry
        got = seap_bucket_lookup(_t(key.astype(np.int64)), _t(lo),
                                 _t(active))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert active[want].all()


def _scan_waves(B, seed, n_waves=6, n=512):
    """Waves of mixed enqueues and dequeues from a seeded directory, the
    first enqueue-heavy (splits), the last dequeue-heavy (empty buckets,
    merges)."""
    rng = np.random.default_rng(seed)
    lo, active = _directory(B, rng, max(1, B // 3))
    state = (np.zeros(B, np.int32), np.full(B, -1, np.int32), lo, active,
             np.int32(I32MAX), np.int32(I32MIN))
    waves = []
    for w in range(n_waves):
        p_enq = 0.8 if w < n_waves // 2 else 0.2
        waves.append((rng.random(n) < p_enq, _keys(n, rng),
                      rng.random(n) < 0.9))
    return state, waves


def _jax_scan(B, hook):
    fn = jax.jit(j_seap_scan, static_argnames=("n_buckets",
                                               "split_occupancy",
                                               "tier_scan"))
    ts = j_make_tier_scan(B, interpret=True) if hook else None
    return lambda *a, **kw: fn(*a, tier_scan=ts, **kw)


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("B", [1, 8, 300])
def test_seap_queue_scan_matches_jax(B, hook):
    # the JAX loop of 300 masked scans takes minutes to compile on the
    # CPU: at 300 buckets the reference runs its Pallas sweep, the same
    # function (the port's loop and sweep are held against each other)
    state, waves = _scan_waves(B, seed=B + 10 * hook)
    j_scan = _jax_scan(B, hook or B > 8)
    occ = 40
    t_state = tuple(_t(x) for x in state)
    j_state = tuple(jnp.asarray(x) for x in state)
    launches, n_active = tiered_queue_scan.launches, set()
    for e, key, v in waves:
        got = seap_queue_scan(_t(e), _t(key), _t(v), *t_state,
                              n_buckets=B, split_occupancy=occ,
                              tier_scan=make_tier_scan(B) if hook else None)
        want = j_scan(jnp.asarray(e), jnp.asarray(key), jnp.asarray(v),
                      *j_state, n_buckets=B, split_occupancy=occ)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype in (torch.int32, torch.bool), i
            assert a.shape == tuple(b.shape), i
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"output {i}")
        t_state, j_state = got[3:9], want[3:9]
        n_active.add(int(got[9]))
    assert tiered_queue_scan.launches == launches    # plain on CPU tensors
    if B > 1:
        assert len(n_active) > 1, "the directory never changed"


def test_seap_midpoint_formula_matches_int64_floor_at_extremes():
    """(a & b) + ((a ^ b) >> 1) == floor((a + b) / 2) in torch int32."""
    edges = np.array([I32MIN, I32MIN + 1, I32MIN + 2, -3, -1, 0, 1, 3,
                      I32MAX - 2, I32MAX - 1, I32MAX], np.int64)
    rng = np.random.default_rng(7)
    vals = np.concatenate([edges, rng.integers(I32MIN, I32MAX, 64,
                                               dtype=np.int64)])
    a64, b64 = np.meshgrid(vals, vals)
    lo64 = np.minimum(a64, b64).ravel()
    hi64 = np.maximum(a64, b64).ravel()
    want = (lo64 + hi64) >> 1
    a = _t(lo64.astype(np.int32))
    b = _t(hi64.astype(np.int32))
    got = (a & b) + ((a ^ b) >> 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    naive = (a + b).numpy().astype(np.int64) >> 1
    assert (naive != want).any(), "grid never overflows; test is vacuous"


def _fresh(B):
    lo = np.full(B, I32MAX, np.int32)
    lo[0] = I32MIN
    active = np.zeros(B, bool)
    active[0] = True
    return tuple(_t(x) for x in (np.zeros(B, np.int32),
                                 np.full(B, -1, np.int32), lo, active,
                                 np.int32(I32MAX), np.int32(I32MIN)))


def _wave(st, is_enq, valid, keys, B=4, split_occupancy=2):
    out = seap_queue_scan(_t(np.array(is_enq)), _t(np.array(keys, np.int64)),
                          _t(np.array(valid)), *st, n_buckets=B,
                          split_occupancy=split_occupancy)
    return out[:3], out[3:9]


@pytest.mark.parametrize("keys,expect_lo", [
    ([I32MAX, I32MAX - 1, I32MAX - 2], (I32MAX - 3 + I32MAX) >> 1),
    ([I32MIN, I32MIN + 1, I32MIN + 2], (2 * I32MIN + 3) >> 1),
])
def test_seap_split_boundary_exact_at_int32_extremes(keys, expect_lo):
    """A split forced by keys at an int32 edge lands on the exact clamped
    midpoint; a wrapping (lo + hi) // 2 would land across zero."""
    (_, _, matched), st = _wave(_fresh(4), [True] * 3 + [False],
                                [True] * 3 + [False], keys + [0])
    assert bool(matched[:3].all())
    _, _, lo, active, key_lo, key_hi = (x.numpy() for x in st)
    assert active.sum() == 2, "occupancy 3 > 2 must split the root"
    assert int(lo[np.flatnonzero(active)[1]]) == expect_lo
    assert int(key_lo) == min(keys) and int(key_hi) == max(keys)


def test_seap_single_key_bucket_never_resplits():
    keys = [I32MAX] * 3
    _, st = _wave(_fresh(4), [True] * 3 + [False], [True] * 3 + [False],
                  keys + [0])
    n_active = int(st[3].sum())
    for _ in range(3):
        _, st = _wave(st, [True] * 3 + [False], [True] * 3 + [False],
                      keys + [0])
        active, lo = st[3].numpy(), st[2].numpy()
        assert int(active.sum()) == n_active, "a single-key bucket split"
        assert lo[active].min() == I32MIN
    (_, _, matched), st = _wave(st, [False] * 4, [True] * 3 + [False],
                                [0] * 4)
    assert bool(matched[:3].all())


def test_seap_oracle_parity_at_int32_extremes():
    B, occ = 4, 2
    st = _fresh(B)
    oracle = SeapOracle(B, split_occupancy=occ)
    total = 0
    for keys in ([I32MAX, I32MAX - 1, I32MAX - 2],
                 [I32MIN, I32MIN + 1, I32MIN + 2], [I32MAX] * 3,
                 [I32MIN] * 3):
        (bucket, pos, matched), st = _wave(st, [True] * 3 + [False],
                                           [True] * 3 + [False], keys + [0],
                                           B, occ)
        recs = oracle.wave([(ENQ, k, 0) for k in keys] + [None])
        for i, r in enumerate(recs):
            assert (bool(matched[i]), int(bucket[i]), int(pos[i])) == (
                r.matched, r.bucket, r.pos), (keys, i)
        assert int(st[3].sum()) == oracle.n_active
        total += 3
    drained = 0
    while drained < total:
        take = min(3, total - drained)
        valid = [True] * take + [False] * (4 - take)
        (bucket, pos, matched), st = _wave(st, [False] * 4, valid, [0] * 4,
                                           B, occ)
        recs = oracle.wave([(DEQ, 0, None)] * take + [None] * (4 - take))
        for i, r in enumerate(recs):
            assert (bool(matched[i]), int(bucket[i]), int(pos[i])) == (
                r.matched, r.bucket, r.pos), (drained, i)
        drained += take
    assert oracle.size == 0 and int((st[1] - st[0] + 1).sum()) == 0


# ------------------------------------------------------ structures --------
N, CAP, W, L, K = 4, 16, 2, 4, 3
OCC = 6
KEYS = ("bucket", "pos", "m", "dv", "dok", "ovf", "nact")
PLAN = [("burst", 0.7), ("burst", 0.7), ("grow", 2), ("burst", 0.5),
        ("shrink", [0, 2, 4]), ("burst", 0.6), ("grow", 2), ("burst", 0.2)]
EXTRA_MIX = 0.5
# name -> (n_buckets, seed bounds)
CONFIGS = {"cold": (4, None), "seeded": (8, [-500, 0, 500])}


def _bursts(seed=0):
    """One (E, V, KY, PW) per burst of PLAN plus the extra burst; keys
    over [-1000, 1000) with a few at the int32 edges, payload word 0 the
    op's global id."""
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
            KY = rng.integers(-1000, 1000, (K, nL)).astype(np.int64)
            edge = rng.random((K, nL))
            KY[edge < 0.05], KY[edge > 0.95] = I32MIN, I32MAX
            PW = np.zeros((K, nL, W), np.int32)
            PW[..., 0] = np.arange(op_id, op_id + K * nL).reshape(K, nL)
            PW[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (K, nL),
                                      dtype=np.int64).astype(np.int32)
            op_id += K * nL
            out.append((E, V, KY.astype(np.int32), PW))
    return out


JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dqueue import DeviceSeapQueue, ElasticDeviceSeapQueue
d = np.load(IN, allow_pickle=False)
out = {}
def arrs(b, k=None):
    xs = [d[f"{c}{b}"] for c in ("E", "V", "KY", "PW")]
    return [jnp.asarray(x if k is None else x[k]) for x in xs]
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
for name, pipelined in (("pipe", True), ("seq", False)):
    q = DeviceSeapQueue(mesh, "data", n_buckets=4, cap=CAP, payload_width=2,
                        ops_per_shard=4, split_occupancy=OCC,
                        pipelined=pipelined)
    st = q.init_state()
    st, *o = q.step(st, *arrs(0, 0))
    for k, v in zip(KEYS, o):
        out[f"{name}_step_{k}"] = np.asarray(v)
    st, *o = q.run_waves(st, *arrs(1))
    for k, v in zip(KEYS, o):
        out[f"{name}_burst_{k}"] = np.asarray(v)
    for k in st._fields:
        out[f"{name}_{k}"] = np.asarray(getattr(st, k))
for cfg, (B, seeds) in CONFIGS.items():
    eq = ElasticDeviceSeapQueue(4, n_buckets=B, seed_bounds=seeds, cap=CAP,
                                payload_width=2, ops_per_shard=4,
                                split_occupancy=OCC)
    b, mig = 0, 0
    for action, arg in PLAN:
        if action == "burst":
            for k, v in zip(KEYS, eq.run_waves(*arrs(b))):
                out[f"{cfg}_b{b}_{k}"] = np.asarray(v)
            b += 1
            continue
        st = eq.grow(arg) if action == "grow" else eq.shrink(arg)
        hb = st["hash_balance"]
        out[f"{cfg}_mig{mig}"] = np.array(
            [st["moved"], eq.size, hb["n"], hb["max"], hb["min"],
             hb["roundrobin_max"], st["P_to"], eq.n_active] + list(eq.sizes))
        out[f"{cfg}_mig{mig}_dir"] = np.array(eq.directory())
        mig += 1
    for k, v in eq._state_dict().items():
        out[f"{cfg}_final_{k}"] = np.asarray(v)
    for k, v in zip(KEYS, eq.run_waves(*arrs(b))):
        out[f"{cfg}_x_{k}"] = np.asarray(v)
    for k, v in eq._state_dict().items():
        out[f"{cfg}_after_{k}"] = np.asarray(v)
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seap")
    arrays = {f"{c}{i}": x for i, bt in enumerate(_bursts())
              for c, x in zip(("E", "V", "KY", "PW"), bt)}
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              f"PLAN = {PLAN!r}\nKEYS = {KEYS!r}\nCAP = {CAP}\nOCC = {OCC}\n"
              f"CONFIGS = {CONFIGS!r}\n" + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _assert_state_equal(port: dict, jax_run: dict, prefix: str, B: int):
    junk = B * CAP
    for k in SeapQueueState._fields:
        want = jax_run[f"{prefix}_{k}"]
        got = port[k]
        if k == "store_vals":
            # which duplicate write lands on the junk slot is unspecified
            got, want = got[:, :junk], want[:, :junk]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _device_run(pipelined):
    q = DeviceSeapQueue(N, n_buckets=4, cap=CAP, payload_width=W,
                        ops_per_shard=L, split_occupancy=OCC,
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
def test_device_seap_queue_matches_jax(jax_run, pipelined):
    name = "pipe" if pipelined else "seq"
    port = _device_run(pipelined)
    for k in [f"{p}_{k}" for p in ("step", "burst") for k in KEYS]:
        np.testing.assert_array_equal(port[k], jax_run[f"{name}_{k}"],
                                      err_msg=k)
    _assert_state_equal(port, jax_run, name, 4)
    assert port["step_ex"] == 2
    assert port["burst_ex"] == (K + 1 if pipelined else 2 * K)
    assert port["burst_nact"].shape == (K,)


def _burst(eq, E, V, KY, PW):
    o = eq.run_waves(_t(E), _t(V), _t(KY), _t(PW))
    return {k: v.numpy() for k, v in zip(KEYS, o)}


def _elastic(cfg, n_shards=N):
    B, seeds = CONFIGS[cfg]
    return ElasticDeviceSeapQueue(n_shards, n_buckets=B, seed_bounds=seeds,
                                  cap=CAP, payload_width=W, ops_per_shard=L,
                                  split_occupancy=OCC, pool_size=8,
                                  device="cpu")


@pytest.fixture(scope="module")
def port_runs():
    runs = {}
    bursts = _bursts()
    for cfg in CONFIGS:
        eq = _elastic(cfg)
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
            migs.append((st, eq.size, eq.sizes, eq.n_active,
                         eq.directory()))
        runs[cfg] = (eq, out, migs)
    return runs


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_elastic_seap_matches_jax_through_join_and_leave(jax_run, port_runs,
                                                         cfg):
    eq, out, _ = port_runs[cfg]
    n_bursts = sum(a == "burst" for a, _ in PLAN)
    for b in range(n_bursts):
        for k in KEYS:
            np.testing.assert_array_equal(out[f"b{b}_{k}"],
                                          jax_run[f"{cfg}_b{b}_{k}"],
                                          err_msg=f"burst {b} {k}")
    assert eq.n_shards == 5 and len(eq.migrations) == 3
    _assert_state_equal(state_to_numpy(eq.state), jax_run, f"{cfg}_final",
                        CONFIGS[cfg][0])
    assert any(out[f"b{b}_dok"].any() for b in range(n_bursts))
    nact = np.concatenate([out[f"b{b}_nact"] for b in range(n_bursts)])
    assert len(set(nact.tolist())) > 1, "the directory never changed"


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_elastic_seap_migrations_match_jax(jax_run, port_runs, cfg):
    eq, _, migs = port_runs[cfg]
    for i, (st, size, sizes, n_active, directory) in enumerate(migs):
        want = [int(x) for x in jax_run[f"{cfg}_mig{i}"]]
        moved, jsize, n, mx, mn, rr, P_to, jact = want[:8]
        assert st["moved"] == moved == size == jsize
        assert sizes == want[8:] and n_active == jact
        assert directory == [tuple(e) for e in
                             jax_run[f"{cfg}_mig{i}_dir"].tolist()]
        assert st["P_to"] == P_to
        hb = st["hash_balance"]
        assert (hb["n"], hb["max"], hb["min"], hb["roundrobin_max"]) == (
            n, mx, mn, rr)
        assert sum(hb["counts"]) == hb["n"] and len(hb["counts"]) == P_to
    pr = eq.pressure()
    assert pr["n_windows"] == CONFIGS[cfg][0]
    assert pr["occupancy"] == eq.sizes
    assert eq.window_capacity() == eq.n_shards * CAP


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_continue_from_jax_seap_state(jax_run, cfg):
    pre = f"{cfg}_final_"
    d = {k[len(pre):]: v for k, v in jax_run.items() if k.startswith(pre)}
    eq = _elastic(cfg, n_shards=5)
    eq.state = state_from_jax(d, "cpu")
    assert isinstance(eq.state, SeapQueueState)
    got = _burst(eq, *_bursts()[-1])
    for k in KEYS:
        np.testing.assert_array_equal(got[k], jax_run[f"{cfg}_x_{k}"],
                                      err_msg=k)
    _assert_state_equal(state_to_numpy(eq.state), jax_run, f"{cfg}_after",
                        CONFIGS[cfg][0])


def test_interop_takes_the_most_specific_layout(jax_run):
    """A Seap state dict holds every key of a priority one: it must come
    back as a Seap state with its directory, and a priority dict as a
    priority state."""
    pre = "seeded_final_"
    d = {k[len(pre):]: v for k, v in jax_run.items() if k.startswith(pre)}
    st = state_from_jax(d, "cpu")
    assert type(st) is SeapQueueState
    np.testing.assert_array_equal(st.lo.numpy(), d["lo"])
    assert st.active.dtype == torch.bool and st.key_lo.dim() == 0
    pq = state_from_jax({k: d[k] for k in PriorityQueueState._fields}, "cpu")
    assert type(pq) is PriorityQueueState
    with pytest.raises(ValueError):
        state_from_jax({**d, "lo": d["lo"][:-1]}, "cpu")


@pytest.mark.parametrize("B,seeds", [(4, None), (8, [-500, 0, 500])])
def test_elastic_seap_matches_oracle(B, seeds):
    eq = ElasticDeviceSeapQueue(4, n_buckets=B, cap=32, payload_width=2,
                                ops_per_shard=4, split_occupancy=6,
                                seed_bounds=seeds, pool_size=8, device="cpu")
    oracle = SeapOracle(B, split_occupancy=6, seed_bounds=seeds)
    ref_oracle = RefSeapOracle(B, split_occupancy=6, seed_bounds=seeds)
    rng = np.random.default_rng(1000 + B)
    for it in range(14):
        if it == 5:
            assert eq.grow(2)["moved"] == eq.size == oracle.size
        if it == 10:
            assert eq.shrink([0, 3])["moved"] == eq.size == oracle.size
        n = eq.n_shards * eq.L
        e, v = rng.random(n) < 0.55, rng.random(n) < 0.9
        key = rng.integers(-1000, 1000, n).astype(np.int32)
        pw = np.zeros((n, 2), np.int32)
        pw[:, 0] = rng.integers(0, 1 << 20, n)
        bucket, pos, m, dv, dok, ovf, nact = (
            x.numpy() for x in eq.step(e, v, key, pw))
        assert not ovf
        ops = [None if not v[i] else
               ((ENQ, int(key[i]), int(pw[i, 0])) if e[i]
                else (DEQ, 0, None)) for i in range(n)]
        recs = oracle.wave(ops)
        assert [vars(r) for r in recs] == [
            vars(r) for r in ref_oracle.wave(ops)]
        for i, r in enumerate(recs):
            assert (bool(m[i]), int(bucket[i]), int(pos[i])) == (
                r.matched, r.bucket, r.pos), (it, i)
            if r.matched and r.value is not None:
                assert dok[i] and int(dv[i, 0]) == r.value, (it, i)
        assert oracle.directory() == ref_oracle.directory()
        assert int(nact) == oracle.n_active == eq.n_active
        assert eq.directory() == oracle.directory()
    assert eq.sizes == oracle.sizes
    assert oracle.n_splits > 0 and oracle.n_merges > 0


def test_bucket_overflow_raises_with_per_bucket_occupancy():
    q = ElasticDeviceSeapQueue(1, n_buckets=2, cap=2, payload_width=1,
                               ops_per_shard=4, split_occupancy=99,
                               device="cpu")
    one = np.ones((4, 1), np.int32)
    key = np.zeros(4, np.int32)
    fill = np.array([True, True, False, False])
    q.step(fill, fill, key, one)
    assert q.sizes == [2, 0] and q.headroom() == [0, 2]
    e = np.array([True, False, False, False])
    v = np.array([True, True, False, False])
    with pytest.raises(QueueOverflowError) as err:
        q.step(e, v, key, one)
    assert err.value.kind == "squeue" and err.value.capacity == 2
    assert err.value.occupancy == [2, 0] and err.value.wave is None


def test_seed_bounds_validation():
    with pytest.raises(ValueError):
        check_seed_bounds([1, 2], 2)                 # more than B - 1
    with pytest.raises(ValueError):
        check_seed_bounds([5, 5], 4)                 # not strictly rising
    with pytest.raises(ValueError):
        check_seed_bounds([I32MIN], 4)               # the root's boundary
    assert check_seed_bounds(np.array([3, 9]), 3) == [3, 9]
    with pytest.raises(ValueError):
        DeviceSeapQueue(1, n_buckets=2, seed_bounds=[3, 9], device="cpu")
    with pytest.raises(ValueError):
        ElasticDeviceSeapQueue(1, n_buckets=2, seed_bounds=[3, 9],
                               device="cpu")
    q = DeviceSeapQueue(2, n_buckets=4, seed_bounds=[-7, I32MAX],
                        device="cpu")
    st = q.init_state()
    assert st.lo.tolist() == [I32MIN, -7, I32MAX, I32MAX]
    assert st.active.tolist() == [True, True, True, False]


def test_seap_queue_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceSeapQueue(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticDeviceSeapQueue(4)
