"""The port's LIFO stack against the JAX reference, bit for bit.

The stack scan: the same numpy inputs go through
``repro.core.scan_queue.stack_scan``, ``stack_scan_pallas(interpret=True)``
and the port's ``stack_scan`` on CPU tensors (its plain version), with
``last``/``ticket`` at the pop clamp (0, 1) and near the ticket's int32
edge.  The stack: the JAX ``DeviceStack`` (4 shards, pipelined and
sequential) and ``ElasticDeviceStack`` (4 -> 6 -> 3 -> 5 shards) run in
one forced-multi-device subprocess that writes an ``.npz``; the port runs
the same waves on ``device="cpu"``.  Positions, matched flags, popped
values, ok and overflow flags, migration ``moved`` and hash balance, and
the final store (junk slot excluded) must be equal.  Also: the paper's
host protocol, the port's ``repro_torch.core.protocol.Skueue`` in stack
mode through JOIN/LEAVE (its records equal to the reference's
``repro.core.protocol.Skueue`` on the same schedule), pipelined == sequential, a JAX final state continued in the port,
and the slot-depth overflow error.  All outputs are integers: the
tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from multidev import run_multidev
from repro.core.consistency import \
    check_sequential_consistency as ref_check_sequential_consistency
from repro.core.protocol import Skueue as RefSkueue
from repro.core.scan_queue import StackState as JStackState
from repro.core.scan_queue import stack_compose as j_compose
from repro.core.scan_queue import stack_op_transforms as j_transforms
from repro.core.scan_queue import stack_scan as _j_stack_scan
from repro.kernels.segscan import stack_scan_pallas

from repro_torch.core.consistency import check_sequential_consistency
from repro_torch.core.protocol import DEQ, ENQ, Skueue
from repro_torch.core.scan_queue import (StackState, stack_compose,
                                         stack_op_transforms)
from repro_torch.core.scan_queue import stack_scan as t_core_scan
from repro_torch.dqueue import (DeviceStack, ElasticDeviceStack,
                                QueueOverflowError)
from repro_torch.interop import state_from_jax, state_to_numpy
from repro_torch.kernels.segscan import stack_scan, stack_scan_ref

j_stack_scan = jax.jit(_j_stack_scan)   # eager dispatch is slow on CPU


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


# (n, push share, valid share, last, ticket)
SCAN_CASES = {
    "ragged": (1500, 0.6, 0.8, 0, 0),
    "all_pop_from_one": (1024, 0.0, 1.0, 1, 9),
    "all_push": (2049, 1.0, 1.0, 0, 0),
    "pops_at_clamp": (777, 0.3, 1.0, 0, 3),
    "big_state": (2048 + 5, 0.5, 0.9, 1_000_000, 2 ** 30),
    "ticket_near_int32_edge": (1300, 0.5, 0.8, 40, 2 ** 31 - 1400),
    "tiny_pop": (1, 0.0, 1.0, 0, 0),
}


def _scan_case(name, seed=0):
    n, pp, pv, last, tick = SCAN_CASES[name]
    rng = np.random.default_rng(seed)
    return rng.random(n) < pp, rng.random(n) < pv, last, tick


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_stack_scan_matches_jax_core(case):
    e, v, last, tick = _scan_case(case)
    jp, jt, jm, jn = j_stack_scan(jnp.asarray(e),
                                  JStackState(jnp.int32(last),
                                              jnp.int32(tick)),
                                  valid=jnp.asarray(v))
    tp, tt, tm, tl, tk = stack_scan(torch.from_numpy(e), torch.from_numpy(v),
                                    _i32(last), _i32(tick))
    assert tp.dtype == tt.dtype == torch.int32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (int(tl), int(tk)) == (int(jn.last), int(jn.ticket))


@pytest.mark.parametrize("case", ["ragged", "pops_at_clamp", "big_state"])
def test_stack_scan_matches_pallas_interpret(case):
    e, v, last, tick = _scan_case(case, seed=1)
    want = stack_scan_pallas(jnp.asarray(e), jnp.asarray(v), jnp.int32(last),
                             jnp.int32(tick), interpret=True)
    got = stack_scan(torch.from_numpy(e), torch.from_numpy(v), _i32(last),
                     _i32(tick))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stack_scan_without_valid_mask_matches_jax():
    rng = np.random.default_rng(3)
    e = rng.random(300) < 0.45
    jp, jt, jm, jn = j_stack_scan(jnp.asarray(e), JStackState(jnp.int32(4),
                                                              jnp.int32(11)))
    tp, tt, tm, tn = t_core_scan(torch.from_numpy(e),
                                 StackState(_i32(4), _i32(11)))
    for a, b in ((tp, jp), (tt, jt), (tm, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(tn.last), int(tn.ticket)) == (int(jn.last), int(jn.ticket))


def test_stack_transforms_and_compose_match_jax():
    rng = np.random.default_rng(4)
    e1, e2 = rng.random(64) < 0.5, rng.random(64) < 0.5
    jt1, jt2 = j_transforms(jnp.asarray(e1)), j_transforms(jnp.asarray(e2))
    tt1 = stack_op_transforms(torch.from_numpy(e1))
    tt2 = stack_op_transforms(torch.from_numpy(e2))
    for a, b in zip(tt1, jt1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(stack_compose(tt1, tt2), j_compose(jt1, jt2)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the compose is not commutative: (POP ; PUSH) != (PUSH ; POP)
    pop = stack_op_transforms(torch.tensor([False]))
    push = stack_op_transforms(torch.tensor([True]))
    assert ([int(x) for x in stack_compose(pop, push)]
            != [int(x) for x in stack_compose(push, pop)])


def test_stack_scan_is_plain_on_cpu_tensors():
    e, v, last, tick = _scan_case("ragged")
    args = (torch.from_numpy(e), torch.from_numpy(v), _i32(last), _i32(tick))
    before = stack_scan.launches
    out = stack_scan(*args)
    assert stack_scan.launches == before       # the kernel never ran
    for a, b in zip(out, stack_scan_ref(*args)):
        assert torch.equal(a, b)


# ------------------------------------------------------ structures --------
N, CAP, W, L, D, K = 4, 8, 2, 4, 8, 3
KEYS = ("pos", "m", "dv", "dok", "ovf")
# (action, argument): bursts carry their push share.  At every migration
# the stack fits both the old and the new slots (31 of 4 x 8 at the grow,
# 11 of 3 x 8 at the shrink).  Depth 8: a wave may push one position many
# times (pushes apply before pops), each push taking a depth entry.
PLAN = [("burst", 0.75), ("burst", 0.75), ("grow", 2), ("burst", 0.45),
        ("shrink", [0, 2, 4]), ("burst", 0.6), ("grow", 2), ("burst", 0.2)]
EXTRA_MIX = 0.5


def _bursts(seed=0):
    """One (E, V, P) per burst of PLAN plus the extra burst; payload word 0
    is the op's global id."""
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
            P = np.zeros((K, nL, W), np.int32)
            P[..., 0] = np.arange(op_id, op_id + K * nL).reshape(K, nL)
            P[..., 1] = rng.integers(-2 ** 31, 2 ** 31, (K, nL),
                                     dtype=np.int64).astype(np.int32)
            op_id += K * nL
            out.append((E, V, P))
    return out


JAX_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dqueue import DeviceStack, ElasticDeviceStack
d = np.load(IN, allow_pickle=False)
out = {}
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
for name, pipelined in (("pipe", True), ("seq", False)):
    s = DeviceStack(mesh, "data", cap=8, payload_width=2, ops_per_shard=4,
                    slot_depth=8, pipelined=pipelined)
    st = s.init_state()
    st, *o = s.step(st, jnp.asarray(d["E0"][0]), jnp.asarray(d["V0"][0]),
                    jnp.asarray(d["P0"][0]))
    for k, v in zip(KEYS, o):
        out[f"{name}_step_{k}"] = np.asarray(v)
    st, *o = s.run_waves(st, jnp.asarray(d["E1"]), jnp.asarray(d["V1"]),
                         jnp.asarray(d["P1"]))
    for k, v in zip(KEYS, o):
        out[f"{name}_burst_{k}"] = np.asarray(v)
    for k, v in st.items():
        out[f"{name}_{k}"] = np.asarray(v)
es = ElasticDeviceStack(4, cap=8, payload_width=2, ops_per_shard=4,
                        slot_depth=8)
b, mig = 0, 0
def burst(tag):
    o = es.run_waves(jnp.asarray(d[f"E{b}"]), jnp.asarray(d[f"V{b}"]),
                     jnp.asarray(d[f"P{b}"]))
    for k, v in zip(KEYS, o):
        out[f"{tag}_{k}"] = np.asarray(v)
for action, arg in PLAN:
    if action == "burst":
        burst(f"b{b}"); b += 1
        continue
    st = es.grow(arg) if action == "grow" else es.shrink(arg)
    hb = st["hash_balance"]
    out[f"mig{mig}"] = np.array([st["moved"], es.size, hb["n"], hb["max"],
                                 hb["min"], hb["roundrobin_max"], st["P_to"]])
    mig += 1
for k, v in es._state_dict().items():
    out[f"final_{k}"] = np.asarray(v)
burst("x")
for k, v in es._state_dict().items():
    out[f"after_{k}"] = np.asarray(v)
np.savez(OUT, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stack")
    arrays = {}
    for i, (E, V, P) in enumerate(_bursts()):
        arrays.update({f"E{i}": E, f"V{i}": V, f"P{i}": P})
    np.savez(tmp / "in.npz", **arrays)
    script = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
              f"PLAN = {PLAN!r}\nKEYS = {KEYS!r}\n" + JAX_SCRIPT)
    run_multidev(script, n_dev=8, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _assert_store_equal(port: dict, jax_run: dict, prefix: str):
    assert int(port["last"]) == int(jax_run[f"{prefix}_last"])
    assert int(port["ticket"]) == int(jax_run[f"{prefix}_ticket"])
    # the junk slot (index CAP) is excluded: which duplicate write lands
    # there is unspecified
    np.testing.assert_array_equal(port["ticks"][:, :CAP],
                                  jax_run[f"{prefix}_ticks"][:, :CAP])
    np.testing.assert_array_equal(port["vals"][:, :CAP],
                                  jax_run[f"{prefix}_vals"][:, :CAP])


def _device_stack_run(pipelined):
    s = DeviceStack(N, cap=CAP, payload_width=W, ops_per_shard=L,
                    slot_depth=D, pipelined=pipelined, device="cpu")
    b0, b1 = (tuple(torch.from_numpy(x) for x in b) for b in _bursts()[:2])
    out = {}
    st = s.init_state()
    x0 = s.runtime.n_exchanges
    st, *o = s.step(st, *(x[0] for x in b0))
    out["step_ex"] = s.runtime.n_exchanges - x0
    out.update({f"step_{k}": v.numpy() for k, v in zip(KEYS, o)})
    x0 = s.runtime.n_exchanges
    st, *o = s.run_waves(st, *b1)
    out["burst_ex"] = s.runtime.n_exchanges - x0
    out.update({f"burst_{k}": v.numpy() for k, v in zip(KEYS, o)})
    out.update(state_to_numpy(st))
    return out


@pytest.mark.parametrize("pipelined", [True, False])
def test_device_stack_matches_jax(jax_run, pipelined):
    name = "pipe" if pipelined else "seq"
    port = _device_stack_run(pipelined)
    for k in [f"{p}_{k}" for p in ("step", "burst") for k in KEYS]:
        np.testing.assert_array_equal(port[k], jax_run[f"{name}_{k}"],
                                      err_msg=k)
    _assert_store_equal(port, jax_run, name)
    assert port["step_ex"] == 2
    assert port["burst_ex"] == (K + 1 if pipelined else 2 * K)
    # the junk slot keeps its empty values
    assert (port["ticks"][:, CAP] == -1).all()


def _burst(es, E, V, P):
    o = es.run_waves(torch.from_numpy(E), torch.from_numpy(V),
                     torch.from_numpy(P))
    return {k: v.numpy() for k, v in zip(KEYS, o)}


@pytest.fixture(scope="module")
def port_run():
    bursts = _bursts()
    es = ElasticDeviceStack(N, cap=CAP, payload_width=W, ops_per_shard=L,
                            slot_depth=D, pool_size=8, device="cpu")
    out, b, migs = {}, 0, []
    for action, arg in PLAN:
        if action == "burst":
            out.update({f"b{b}_{k}": v
                        for k, v in _burst(es, *bursts[b]).items()})
            b += 1
            continue
        x0 = es.runtime.n_exchanges
        st = es.grow(arg) if action == "grow" else es.shrink(arg)
        assert es.runtime.n_exchanges - x0 == st["collectives"] == 1
        migs.append((st, es.size))
    return es, out, migs


def test_elastic_stack_matches_jax_through_join_and_leave(jax_run, port_run):
    es, out, _ = port_run
    n_bursts = sum(a == "burst" for a, _ in PLAN)
    for b in range(n_bursts):
        for k in KEYS:
            np.testing.assert_array_equal(out[f"b{b}_{k}"],
                                          jax_run[f"b{b}_{k}"],
                                          err_msg=f"burst {b} {k}")
    assert es.n_shards == 5 and len(es.migrations) == 3
    _assert_store_equal(state_to_numpy(es.state), jax_run, "final")
    # the trace had matched pops and ⊥ pops
    assert any(out[f"b{b}_dok"].any() for b in range(n_bursts))
    E, V, _ = _bursts()[n_bursts - 1]
    assert (V & ~E & ~out[f"b{n_bursts - 1}_m"]).any()


def test_elastic_stack_migrations_match_jax(jax_run, port_run):
    es, _, migs = port_run
    for i, (st, size) in enumerate(migs):
        moved, jsize, n, mx, mn, rr, P_to = (int(x) for x in
                                             jax_run[f"mig{i}"])
        assert st["moved"] == moved == size == jsize
        assert st["P_to"] == P_to
        assert st["bytes_moved"] == moved * 4 * (3 + W)
        hb = st["hash_balance"]
        assert (hb["n"], hb["max"], hb["min"], hb["roundrobin_max"]) == (
            n, mx, mn, rr)
        assert sum(hb["counts"]) == hb["n"] and len(hb["counts"]) == P_to
    assert es.window_capacity() == es.n_shards * CAP * D


def test_continue_from_jax_stack_state(jax_run):
    bursts = _bursts()
    d = {k[len("final_"):]: v for k, v in jax_run.items()
         if k.startswith("final_")}
    es = ElasticDeviceStack(5, cap=CAP, payload_width=W, ops_per_shard=L,
                            slot_depth=D, pool_size=8, device="cpu")
    es.state = state_from_jax(d, "cpu")
    got = _burst(es, *bursts[-1])
    for k in KEYS:
        np.testing.assert_array_equal(got[k], jax_run[f"x_{k}"], err_msg=k)
    _assert_store_equal(state_to_numpy(es.state), jax_run, "after")


def test_stack_pipelined_equals_sequential_and_steps():
    E, V, P = (torch.from_numpy(x) for x in _bursts(seed=7)[1])
    outs = []
    for pipelined in (True, False):
        s = DeviceStack(N, cap=CAP, payload_width=W, ops_per_shard=L,
                        slot_depth=D, pipelined=pipelined, device="cpu")
        st, *o = s.run_waves(s.init_state(), E, V, P)
        outs.append(o + [st.ticks[:, :CAP], st.vals[:, :CAP]])
    st = s.init_state()
    steps = []
    for k in range(K):
        st, *o = s.step(st, E[k], V[k], P[k])
        steps.append(o)
    outs.append([torch.stack(c) for c in zip(*steps)]
                + [st.ticks[:, :CAP], st.vals[:, :CAP]])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_slot_depth_overflow_raises():
    # 2 shards x 2 slots x depth 1: the 5th push finds its slot full
    es = ElasticDeviceStack(2, cap=2, payload_width=1, ops_per_shard=2,
                            slot_depth=1, device="cpu")
    full = np.ones((1, 4), bool)
    es.run_waves(full, full, np.zeros((1, 4, 1), np.int32))
    assert es.size == 4 and es.headroom() == [0]
    one = np.array([[True, False, False, False]])
    with pytest.raises(QueueOverflowError) as err:
        es.run_waves(one, one, np.zeros((1, 4, 1), np.int32))
    assert err.value.wave == 0 and err.value.capacity == 4
    assert err.value.kind == "stack" and err.value.occupancy == [5]


def test_stack_reshard_guards():
    es = ElasticDeviceStack(4, cap=2, payload_width=1, ops_per_shard=2,
                            pool_size=8, device="cpu")
    full = np.ones((1, 8), bool)
    es.run_waves(full, full, np.zeros((1, 8, 1), np.int32))
    with pytest.raises(ValueError, match="exceed the new capacity"):
        es.shrink([0, 1, 2])
    # 16 live elements on 4 x 2 slots: each slot holds two positions, and
    # the migration recovers one position per slot, so it must refuse
    # (the reference moves the deeper entries to wrong slots instead)
    es.run_waves(full, full, np.zeros((1, 8, 1), np.int32))
    assert es.size == 16
    with pytest.raises(ValueError, match="current slots"):
        es.grow(4)
    assert es.n_shards == 4 and es.size == 16


# ----------------------------------------------- the paper's protocol -----
PROTO_OPS = (np.random.default_rng(23).random(96) < 0.6).tolist()
SCHEDULE = {24: ("grow", 2), 48: ("shrink", [0, 4]), 72: ("grow", 1)}


def _run_port_trace(es):
    pos_l, bot_l, res_l = [], [], []
    start = 0
    for end in sorted(SCHEDULE) + [len(PROTO_OPS)]:
        chunk = PROTO_OPS[start:end]
        n = es.n_shards * es.L
        Kc = -(-len(chunk) // n)
        E = np.zeros((Kc, n), bool)
        V = np.zeros((Kc, n), bool)
        PW = np.zeros((Kc, n, 2), np.int32)
        for j, op in enumerate(chunk):
            k, i = divmod(j, n)
            E[k, i], V[k, i], PW[k, i, 0] = bool(op), True, start + j
        pos, m, dv, dok, _ = (x.numpy() for x in es.run_waves(E, V, PW))
        pos, m, dok = (x.reshape(-1)[:len(chunk)] for x in (pos, m, dok))
        dv = dv.reshape(-1, 2)[:len(chunk)]
        for j, op in enumerate(chunk):
            pos_l.append(int(pos[j]))
            bot_l.append((not op) and not m[j])
            if (not op) and m[j]:
                assert dok[j], f"matched pop {start + j} lost its element"
                res_l.append(int(dv[j, 0]))
            else:
                res_l.append(None)
        if end in SCHEDULE:
            kind, arg = SCHEDULE[end]
            st = es.grow(arg) if kind == "grow" else es.shrink(arg)
            assert st["moved"] == es.size
        start = end
    return pos_l, bot_l, res_l


def _run_protocol(cls=Skueue, check=check_sequential_consistency):
    sk = cls(4, mode="stack", seed=0, local_combining=False)
    nid = sk.ring.node_ids()[0]
    rids = []

    def inject(s, rnd):
        i = rnd - 1
        if i < len(PROTO_OPS):
            rids.append(s.inject(nid, ENQ if PROTO_OPS[i] else DEQ))
        if i in SCHEDULE:
            kind, arg = SCHEDULE[i]
            if kind == "grow":
                for _ in range(arg):
                    s.request_join()
            else:
                keep = s.ring.proc[nid]
                alive = sorted({s.ring.proc[v] for v in s.ring.node_ids()})
                for pid in [p for p in alive if p != keep][:len(arg)]:
                    s.request_leave(pid)

    sk.run_rounds(len(PROTO_OPS) + 80, inject_fn=inject)
    assert all(sk.requests[r].done for r in rids)
    assert sk.update_phases >= 2, "membership schedule never took effect"
    check(sk)
    reqs = [sk.requests[r] for r in rids]
    pos_l = [-1 if r.pos is None else r.pos for r in reqs]
    bot_l = [r.kind == DEQ and r.result == -1 for r in reqs]
    res_l = [r.result if r.kind == DEQ and r.result != -1 else None
             for r in reqs]
    return sk, pos_l, bot_l, res_l


def test_elastic_stack_matches_skueue_protocol():
    es = ElasticDeviceStack(4, cap=32, payload_width=2, ops_per_shard=4,
                            slot_depth=8, pool_size=8, device="cpu")
    d_pos, d_bot, d_res = _run_port_trace(es)
    sk, p_pos, p_bot, p_res = _run_protocol()
    ref, *ref_lists = _run_protocol(RefSkueue,
                                    ref_check_sequential_consistency)
    assert [p_pos, p_bot, p_res] == ref_lists
    assert [vars(r) for r in sk.requests] == [vars(r) for r in ref.requests]
    assert (sk.total_msgs, sk.update_phases, vars(sk.anchor_state)) == (
        ref.total_msgs, ref.update_phases, vars(ref.anchor_state))
    assert d_pos == p_pos, "stack positions diverged"
    assert d_bot == p_bot, "unmatched-pop (⊥) sets diverged"
    assert d_res == p_res, "pop sequences diverged (lost or reordered)"
    assert int(es.state.last) == sk.anchor_state.last
    assert int(es.state.ticket) == sk.anchor_state.ticket
    assert sum(r is not None for r in d_res) > 0 and any(d_bot)
