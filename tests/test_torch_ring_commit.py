"""The Stage-4 store rewrite's plain version against the JAX reference.

``repro_torch.kernels.ring_commit`` is the wave engine's commit: one CUDA
launch on the card (``csrc/ring_commit.cu``, held against the plain
version in ``tests/test_torch_gpu.py``), the plain version on the CPU.
Here the plain version meets ``repro.dqueue.wave_engine.ring_commit``,
which the reference runs per shard, bit for bit: on every commit that the
FIFO queue of ``test_torch_wave_engine.py`` makes (pipelined and
sequential), and on built receive buffers (a PUT and a GET of one slot in
one wave, a GET of an empty slot, the all-sentinel priming buffer, a
strided view of a wider buffer, fewer local shards than sources, W of 1,
2 and 4).  Compared: the store without its junk row (which duplicate
write lands there is unspecified), every full bit, the reply's ``ok`` on
every row and its value on every GET row.  Also: a CPU tensor never
reaches the kernel, the launcher's checks and cluster sizes, the CUDA
source's constants, the wave lint over the wrapper, and the wave
engine asking for its scan and commit libraries together on CUDA only.
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.dqueue import wave_engine as jwe

from repro_torch.analysis.astlint import lint_source
from repro_torch.core.wave_tags import TAG_GET, TAG_INACTIVE, TAG_PUT
from repro_torch.dqueue import (DevicePriorityQueue, DeviceQueue,
                                DeviceSeapQueue)
from repro_torch.dqueue import device_queue as tdq
from repro_torch.dqueue import wave_engine as twe
from repro_torch.kernels import backend
from repro_torch.kernels.ring_commit import kernel, ring_commit, ring_commit_ref


def _jax_commit(sv, sf, recv, junk, W):
    """The reference's per-shard commit over every destination row."""
    outs = [jwe.ring_commit((jnp.asarray(sv[d:d + 1].numpy()),
                             jnp.asarray(sf[d:d + 1].numpy())),
                            jnp.asarray(recv[d].contiguous().numpy()),
                            junk, W)
            for d in range(sv.shape[0])]
    return (np.concatenate([np.asarray(o[0][0]) for o in outs]),
            np.concatenate([np.asarray(o[0][1]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]),
            [bool(o[2]) for o in outs])


def _assert_commits_agree(sv, sf, recv, junk, W):
    """The port's plain commit on copies of the store against the
    reference's, on the fields that are specified."""
    (pv, pf), reply, ovf = ring_commit_ref((sv.clone(), sf.clone()), recv,
                                           junk, W)
    jv, jf, jreply, jovf = _jax_commit(sv, sf, recv, junk, W)
    np.testing.assert_array_equal(pv[:, :junk].numpy(), jv[:, :junk])
    np.testing.assert_array_equal(pf.numpy(), jf)
    assert not pf[:, junk].any()
    np.testing.assert_array_equal(reply[..., 0].numpy(), jreply[..., 0])
    get = (recv[..., 1] == TAG_GET).numpy()
    np.testing.assert_array_equal(reply.numpy()[get], jreply[get])
    assert ovf.shape == () and not bool(ovf) and not any(jovf)
    return pv, pf, reply


def _store(n, junk, W, seed, full_share=0.5):
    rng = np.random.default_rng(seed)
    sv = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, junk + 1, W),
                                       dtype=np.int64).astype(np.int32))
    sf = torch.from_numpy(rng.random((n, junk + 1)) < full_share)
    sf[:, junk] = False
    return sv, sf


def _recv(n, n_src, L, W, junk, seed, active=0.3):
    """Rows ``slot ‖ tag ‖ payload`` with distinct slots per destination
    (as a wave's positions are), inactive rows as the engine's fill."""
    rng = np.random.default_rng(seed)
    rows = n_src * L
    slot = np.full((n, rows), junk, np.int32)
    tag = np.full((n, rows), TAG_INACTIVE, np.int32)
    for d in range(n):
        act = np.flatnonzero(rng.random(rows) < active)
        slot[d, act] = rng.permutation(junk)[:act.size]
        tag[d, act] = np.where(rng.random(act.size) < 0.5, TAG_PUT, TAG_GET)
    pay = rng.integers(-2 ** 31, 2 ** 31, (n, rows, W),
                       dtype=np.int64).astype(np.int32)
    pay[tag == TAG_INACTIVE] = 0
    r = np.concatenate([slot[..., None], tag[..., None], pay], -1)
    return torch.from_numpy(r.reshape(n, n_src, L, 2 + W))


@pytest.mark.parametrize("pipelined", [True, False])
def test_plain_commit_matches_jax_on_the_wave_engine_waves(monkeypatch,
                                                           pipelined):
    """Every commit of test_torch_wave_engine.py's FIFO waves (4 shards,
    cap 8, W 2, L 4; a first wave of dequeues on the empty queue), its
    inputs recorded as the disciplines pass them: the pipelined path's
    strided view and priming buffer included."""
    from test_torch_wave_engine import CAP, L, N, W, _waves
    seen = []

    def record(store, recv, junk, W_):
        seen.append((store[0].clone(), store[1].clone(), recv, junk, W_))
        return ring_commit(store, recv, junk, W_)
    monkeypatch.setattr(tdq, "ring_commit", record)
    q = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                    pipelined=pipelined, device="cpu")
    E, V, P = (torch.from_numpy(x) for x in _waves())
    st = q.init_state()
    st, *_ = q.step(st, E[0], V[0], P[0])
    q.run_waves(st, E[1:], V[1:], P[1:])
    assert len(seen) == (1 + 4 if pipelined else 1 + 3)
    strides = {r.stride() for *_, r, _, _ in seen}
    if pipelined:    # the priming expand and the request ‖ reply view
        assert (0, 0, 0, 1) in strides
        assert any(s[2] == 2 + W + 1 + W for s in strides)
    gets = 0
    for sv, sf, recv, junk, W_ in seen:
        _, _, reply = _assert_commits_agree(sv, sf, recv, junk, W_)
        gets += int(reply[..., 0].sum())
    assert gets > 0                   # some dequeue found a value


@pytest.mark.parametrize("case", ["w4", "w2", "w1", "local_of_src",
                                  "strided", "priming", "dense_active"])
def test_plain_commit_matches_jax_on_built_buffers(case):
    n, n_src, L, W, junk = 4, 4, 16, 4, 96
    if case in ("w2", "w1"):
        W = int(case[1])
    if case == "local_of_src":
        n, n_src = 2, 4
    if case == "priming":
        fill = torch.tensor([junk, TAG_INACTIVE] + [0] * W, dtype=torch.int32)
        recv = fill.expand(n, n_src, L, 2 + W)
    else:
        recv = _recv(n, n_src, L, W, junk, seed=len(case),
                     active=0.9 if case == "dense_active" else 0.3)
    if case == "strided":      # rows inside a wider request ‖ reply buffer
        wide = torch.cat([recv, torch.full((n, n_src, L, 1 + W), 7,
                                           dtype=torch.int32)], -1)
        recv = wide[..., :2 + W]
        assert not recv.is_contiguous()
    sv, sf = _store(n, junk, W, seed=3)
    pv, pf, _ = _assert_commits_agree(sv, sf, recv, junk, W)
    if case == "priming":      # commits as a no-op
        assert torch.equal(pv[:, :junk], sv[:, :junk])
        assert torch.equal(pf, sf)


def test_plain_commit_put_and_get_of_one_slot_and_an_empty_get():
    """A PUT and a GET of one slot in one wave: the GET reads the PUT and
    clears it; a GET of an empty slot: ok false, its value passed
    through; a GET of a full slot: ok true, cleared."""
    junk, W = 8, 2
    sv = torch.arange(2 * (junk + 1) * W, dtype=torch.int32).view(
        2, junk + 1, W)
    sf = torch.zeros(2, junk + 1, dtype=torch.bool)
    sf[0, 5] = True
    rows = [[3, TAG_PUT, 41, 42], [3, TAG_GET, 0, 0], [1, TAG_GET, 9, 9],
            [5, TAG_GET, 0, 0], [junk, TAG_INACTIVE, 0, 0]]
    recv = torch.tensor([rows, rows], dtype=torch.int32).view(2, 1, 5, 4)
    recv[1, ..., 1] = TAG_INACTIVE
    pv, pf, reply = _assert_commits_agree(sv, sf, recv, junk, W)
    assert reply[0, 0, 1].tolist() == [1, 41, 42]
    assert reply[0, 0, 2].tolist() == [0, *sv[0, 1].tolist()]
    assert reply[0, 0, 3].tolist() == [1, *sv[0, 5].tolist()]
    assert not pf.any()
    assert pv[0, 3].tolist() == [41, 42]


def test_cpu_tensors_never_reach_the_kernel():
    n, n_src, L, W, junk = 3, 3, 8, 4, 40
    recv = _recv(n, n_src, L, W, junk, seed=5)
    sv, sf = _store(n, junk, W, seed=6)
    before = ring_commit.launches
    (av, af), ar, ao = ring_commit((sv.clone(), sf.clone()), recv, junk, W)
    (bv, bf), br, bo = ring_commit_ref((sv.clone(), sf.clone()), recv,
                                       junk, W)
    assert torch.equal(av, bv) and torch.equal(af, bf)
    assert torch.equal(ar, br) and torch.equal(ao, bo)
    assert ring_commit.launches == before
    assert twe.ring_commit is ring_commit


@pytest.mark.parametrize("bad", ["dtype", "vals_dtype", "width", "n",
                                 "store_shape", "store_strided"])
def test_launcher_refuses_what_the_kernel_does_not_take(bad):
    """The checks run before anything is built or launched."""
    n, n_src, L, W, junk = 2, 2, 4, 2, 16
    recv = _recv(n, n_src, L, W, junk, seed=8)
    sv, sf = _store(n, junk, W, seed=9)
    if bad == "dtype":
        recv = recv.long()
    elif bad == "vals_dtype":
        sv = sv.long()
    elif bad == "width":
        recv = recv[..., :-1]
    elif bad == "n":
        recv = recv[:1]
    elif bad == "store_shape":
        sf = sf[:, :-1]
    else:
        sv = sv.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="ring_commit_kernel"):
        kernel.ring_commit_kernel((sv, sf), recv, junk, W)


@pytest.mark.parametrize("n_dst,rows,n_sms,want", [
    (64, 64 * 1024, 132, 8),     # the bulk cells
    (48, 48 * 1024, 132, 8),     # the churn cell's narrow waves
    (32, 64 * 1024, 132, 8),     # 32 local shards of 64
    (200, 200 * 1024, 132, 4),   # the grid fills the card first
    (600, 600 * 1024, 132, 1),
    (8, 8 * 16, 132, 1),         # a tiny wave: one block a shard
    (1, 5000, 132, 4),           # rows bound the split
])
def test_cluster_blocks(n_dst, rows, n_sms, want):
    got = kernel.cluster_blocks(n_dst, rows, n_sms)
    assert got == want
    assert 1 <= got <= kernel.MAX_CLUSTER


def test_launcher_constants_match_the_cuda_source():
    src = (backend.CSRC / "ring_commit.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int(?:32_t)? {name} = (\d+);",
                             src).group(1))
    assert (const("kThreads"), const("kUnroll"), const("kMaxCluster"),
            const("kListCap")) == (kernel.THREADS, kernel.UNROLL,
                                   kernel.MAX_CLUSTER, kernel.LIST_CAP)
    assert (const("kTagPut"), const("kTagGet")) == (TAG_PUT, TAG_GET)
    assert "ring_commit" in backend.SOURCES


class _Built(Exception):
    """Stops a wave engine's construction once it has asked for a build."""


def test_a_cuda_wave_engine_builds_its_scan_and_commit_together(
        monkeypatch):
    """A queue wave's scan and commit libraries build in one parallel
    ``nvcc`` round, asked for by the wave engine before anything else."""
    asked = []

    def build(names):
        asked.append(names)
        raise _Built

    monkeypatch.setattr(backend, "build", build)
    with pytest.raises(_Built):
        twe.WaveEngine(4, None, SimpleNamespace(device=torch.device("cuda")))
    assert asked == [("segscan", "ring_commit")] == [twe.WAVE_LIBS]
    assert set(twe.WAVE_LIBS) <= set(backend.SOURCES)


@pytest.mark.parametrize("make", [
    lambda: DeviceQueue(4, cap=8, payload_width=2, ops_per_shard=4,
                        device="cpu"),
    lambda: DevicePriorityQueue(4, n_prios=2, cap=8, payload_width=2,
                                ops_per_shard=4, device="cpu"),
    lambda: DeviceSeapQueue(4, n_buckets=2, cap=8, payload_width=2,
                            ops_per_shard=4, device="cpu"),
], ids=["fifo", "priority", "seap"])
def test_a_cpu_wave_engine_builds_nothing(monkeypatch, make):
    asked = []
    monkeypatch.setattr(backend, "build", lambda names: asked.append(names))
    make()
    assert asked == []


def test_wrapper_passes_the_wave_lint():
    """The wrapper and launcher run inside the wave (the commit stage):
    no host read of a device value, no host callback."""
    from repro_torch.kernels.ring_commit import ops
    names = {"ring_commit", "ring_commit_kernel", "ring_commit_ref",
             "cluster_blocks", "_lib"}
    for mod in (ops, kernel):
        src = open(mod.__file__, encoding="utf-8").read()
        assert lint_source(src, mod.__file__, extra=names) == []
