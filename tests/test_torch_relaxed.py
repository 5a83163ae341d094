"""The relaxed tier resolution against the JAX reference, bit for bit.

The port resolves a relaxed priority wave's dequeues with
``kernels.relaxed.relaxed_deletemin`` (one CUDA launch a wave; its plain
version, a host loop, on CPU tensors); the reference with a ``lax.scan``
inside ``repro.core.scan_queue.priority_queue_scan``.  The same seeded
numpy waves go through both ``priority_queue_scan``s at relaxation 1 and
2 for P in {1, 4, 64, 300}: mixed waves (enqueues, dequeues, padding),
waves whose every dequeue finds the tiers empty (all ⊥), heads near
INT32_MAX that wrap inside the wave, and one shard (every head local).
At 64 and 300 tiers both sides take their tiered-sweep hook for the
enqueues (the reference's Pallas sweep in interpret mode), as their
queues do.  A plain model of the CUDA kernel's event-driven walk
(``relaxed_walk_model``: windows of 1,024 dequeues tested by four warps,
a pass after each relaxed serve and each tier that runs dry, owners by a
reciprocal) is held
against the plain loop past 32 tiers, with a relaxation wider than a
warp, across the int32 wrap at shard counts that do not divide 2^32, and
on shard-major waves at the cells' size (65,536 ops over 64 shards).
Every output is an integer: the tolerance is zero.
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.scan_queue import priority_queue_scan as j_pq_scan
from repro.kernels.segscan import make_tier_scan as j_make_tier_scan

from repro_torch.core.scan_queue import priority_queue_scan
from repro_torch.kernels.relaxed import (relaxed_deletemin,
                                         relaxed_deletemin_ref,
                                         relaxed_walk_model)
from repro_torch.kernels.relaxed.ref import (WALK, WINDOW, fast_floor_mod,
                                             fast_mod, modulo_recip)
from repro_torch.kernels.segscan import make_tier_scan

INT32_MAX = 2 ** 31 - 1


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _wave(n, P, n_shards, seed, *, enq_frac=0.5, empty=False, wrap=False):
    """(is_enq, valid, prio, firsts, lasts, shard_of) for one wave."""
    rng = np.random.default_rng(seed)
    e = rng.random(n) < enq_frac
    v = rng.random(n) < 0.9
    pr = rng.integers(0, P, n).astype(np.int32)
    if empty:
        e[:] = False
        f = rng.integers(-50, 50, P).astype(np.int64)
        size = np.zeros(P, np.int64)
    else:
        f = rng.integers(-1000, 1000, P).astype(np.int64)
        size = rng.integers(0, max(2, 2 * n // P), P)
        size[rng.random(P) < 0.3] = 0            # some tiers start empty
    if wrap:
        f = INT32_MAX - rng.integers(0, n // (4 * P) + 1, P)
    last = f + size - 1
    wrap32 = lambda x: ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    so = (np.arange(n) // (n // n_shards)).astype(np.int32)
    return e, v, pr, wrap32(f), wrap32(last), so


@functools.lru_cache(maxsize=None)
def _j_scan(P, relaxation, n_shards):
    hook = j_make_tier_scan(P, interpret=True) if P > 4 else None
    return jax.jit(functools.partial(
        j_pq_scan, n_prios=P, relaxation=relaxation, n_shards=n_shards,
        tier_scan=hook))


def _both(e, v, pr, f, last, so, P, relaxation, n_shards):
    want = _j_scan(P, relaxation, n_shards)(
        jnp.asarray(e), jnp.asarray(pr), jnp.asarray(v), jnp.asarray(f),
        jnp.asarray(last), shard_of=jnp.asarray(so))
    got = priority_queue_scan(
        _t(e), _t(pr), _t(v), _t(f), _t(last), n_prios=P,
        relaxation=relaxation, shard_of=_t(so), n_shards=n_shards,
        tier_scan=make_tier_scan(P) if P > 4 else None)
    for a, b in zip(got, want):
        assert a.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got


CASES = [(1, 2048), (4, 2048), (64, 2048), (300, 1024)]


@pytest.mark.parametrize("relaxation", [1, 2])
@pytest.mark.parametrize("P,n", CASES)
def test_relaxed_scan_matches_jax(P, n, relaxation):
    got = _both(*_wave(n, P, 8, seed=P + relaxation), P, relaxation, 8)
    if P > 1:
        assert int(got[5]) > 0                   # some serve was relaxed


@pytest.mark.parametrize("relaxation", [1, 2])
@pytest.mark.parametrize("P,n", CASES)
def test_relaxed_all_bottom_matches_jax(P, n, relaxation):
    e, v, pr, f, last, so = _wave(n, P, 8, seed=7, empty=True)
    tier, pos, matched, *_, n_rel = _both(e, v, pr, f, last, so, P,
                                          relaxation, 8)
    assert not matched.any() and (pos == -1).all() and (tier == -1).all()
    assert int(n_rel) == 0


@pytest.mark.parametrize("relaxation", [1, 2])
@pytest.mark.parametrize("P,n", CASES)
def test_relaxed_wrapping_heads_match_jax(P, n, relaxation):
    e, v, pr, f, last, so = _wave(n, P, 8, seed=11, wrap=True)
    _, pos, matched, *_ = _both(e, v, pr, f, last, so, P, relaxation, 8)
    assert (pos[matched] < 0).any()              # heads wrapped past 2^31


@pytest.mark.parametrize("relaxation", [1, 2])
@pytest.mark.parametrize("P", [4, 64])
def test_relaxed_one_shard_matches_jax(P, relaxation):
    # one shard owns every head: the best tier always serves
    got = _both(*_wave(2048, P, 1, seed=3), P, relaxation, 1)
    assert int(got[5]) == 0


def test_relaxed_wrapper_is_plain_on_cpu_tensors():
    e, v, pr, f, last, so = _wave(3000, 4, 8, seed=5, enq_frac=0.0)
    deq = _t(~e & v)
    avail = _t(last) - _t(f) + 1
    before = relaxed_deletemin.launches
    out = relaxed_deletemin(deq, _t(so), avail, _t(f), 4, 2, 8)
    assert relaxed_deletemin.launches == before   # the kernel never ran
    for a, b in zip(out, relaxed_deletemin_ref(deq, _t(so), avail, _t(f),
                                               4, 2, 8)):
        assert torch.equal(a, b)
    assert out[4].dim() == 0 and out[4].dtype == torch.int32


def test_relaxed_kernel_module_imports_without_cuda():
    # the launcher builds and loads its library only when it launches
    from repro_torch.kernels.relaxed import kernel
    assert kernel.MAX_TIERS >= 300
    with pytest.raises(ValueError):
        kernel.relaxed_deletemin_kernel(
            torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
            2, 1, 2)


@pytest.mark.parametrize("P,k,n_shards,kind", [
    (4, 1, 64, "mixed"), (4, 2, 8, "wrap"), (64, 2, 8, "mixed"),
    (300, 2, 64, "mixed"), (40, 40, 8, "mixed"), (1000, 33, 48, "mixed"),
    (1000, 3, 64, "sparse"), (33, 1, 1, "wrap"), (4, 1, 8, "empty"),
    (8, 3, 2, "mixed"), (16, 5, 3, "wrap"), (64, 31, 5, "mixed")])
def test_window_model_matches_the_plain_loop(P, k, n_shards, kind):
    """The kernel's event-driven walk (p* moving past 32 tiers, a window
    wider than a warp, int32 wrap, one shard, every tier empty) equals the
    plain loop, which the tests above hold against JAX."""
    rng = np.random.default_rng(P * 7 + k)
    n = 6000
    deq = rng.random(n) < 0.6
    so = (np.arange(n) * n_shards // n).astype(np.int32)
    hi = {"sparse": 3, "empty": 1}.get(kind, max(2, 3 * n // P))
    avail = rng.integers(0, hi, P).astype(np.int32)
    firsts = rng.integers(-5000, 5000, P).astype(np.int32)
    if kind == "wrap":
        firsts = (INT32_MAX - rng.integers(0, 50, P)).astype(np.int32)
    args = [_t(x) for x in (deq, so, avail, firsts)]
    want = relaxed_deletemin_ref(*args, P, k, n_shards)
    *got, stats = relaxed_walk_model(*args, P, k, n_shards)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert stats["relaxed"] == int(want[4])
    assert stats["chain_steps"] == (stats["steps"] + stats["relaxed"]
                                    + stats["dry"])
    if kind == "empty":
        assert not got[2].any()


def _cell_wave(n, P, n_shards, kind, seed=0, backlog=300_000):
    """A shard-major wave as the priority path sends it (op i on shard
    i * n_shards // n), half dequeues, tier sizes of a backlog-deep queue;
    "edge": heads just below INT32_MAX, so runs cross the int32 wrap."""
    rng = np.random.default_rng(seed)
    deq = rng.random(n) < 0.5
    so = (np.arange(n) * n_shards // n).astype(np.int32)
    avail = rng.integers(backlog // (2 * P), backlog // P + 1, P)
    firsts = rng.integers(0, 1_000_000, P)
    if kind == "edge":
        avail = rng.integers(n // (2 * P), n // P + 1, P)
        firsts = INT32_MAX - rng.integers(0, 64, P)
    return [_t(x) for x in (deq, so, avail.astype(np.int32),
                            firsts.astype(np.int32))]


@pytest.mark.parametrize("P,k,n_shards,kind", [
    (4, 1, 64, "mixed"), (4, 2, 64, "mixed"), (300, 2, 64, "mixed"),
    (4, 2, 48, "edge")])
def test_walk_model_at_the_cells_size(P, k, n_shards, kind):
    """65,536 ops over 64 shards, shard-major: the walk equals the plain
    loop, and its chain is one pass a WINDOW of dequeues plus at most one
    an event (none after an event on a window's last dequeue), so far
    below the one-a-32 of a warp-wide batch."""
    args = _cell_wave(65_536, P, n_shards, kind)
    want = relaxed_deletemin_ref(*args, P, k, n_shards)
    *got, stats = relaxed_walk_model(*args, P, k, n_shards)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    events = stats["relaxed"] + stats["dry"]
    windows = -(-stats["dequeues"] // WINDOW)
    assert windows <= stats["steps"] <= windows + events
    assert stats["chain_steps"] < stats["dequeues"] // 32
    if kind == "edge":
        assert bool((got[1][got[2]] < 0).any())   # heads wrapped


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 48, 64, 100, 1000, 65_536,
                               2 ** 31 - 1, 2 ** 32 - 1])
def test_fast_mod_equals_the_floor_modulo(n):
    """modulo.cuh's reciprocal modulo (the relaxed walk's head owners, the
    hash route's (h >> 8) % n_shards) equals Python's % on uint32 and the
    floor modulo on int32, at the ends of both ranges."""
    rng = np.random.default_rng(n % 1000)
    m = modulo_recip(n)
    xs = [0, 1, n - 1, n, n + 1, 2 ** 24 - 1, 2 ** 31, 2 ** 32 - 1,
          *rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).tolist()]
    for x in xs:
        if 0 <= x < 2 ** 32:
            assert fast_mod(x, n, m) == x % n
    hs = [0, -1, 1, INT32_MAX, -2 ** 31, -n, n, -n - 1,
          *rng.integers(-2 ** 31, 2 ** 31, 2000).tolist()]
    for h in hs:
        if -2 ** 31 <= h <= INT32_MAX:
            assert fast_floor_mod(h, n, m) == h % n


def test_launcher_constants_match_the_cuda_source():
    from pathlib import Path
    from repro_torch.kernels.relaxed import kernel
    src = (Path(kernel.__file__).parents[1] / "csrc" / "relaxed.cu"
           ).read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    warps = int(const("kWarps"))
    producers = int(const("kProducers").split("*")[0]) * 32
    per, lane_deq = int(const("kPer")), int(const("kLaneDeq"))
    assert const("kThreads") == "kWarps * 32"
    assert const("kTile") == "kProducers * kPer"
    assert const("kWalk") == "32 * kLaneDeq"
    assert const("kWindow") == "kWalkers * kWalk"
    walkers = int(const("kWalkers"))
    assert (warps * 32, producers * per, 32 * lane_deq, walkers) == (
        kernel.THREADS, kernel.TILE, kernel.WALK, kernel.WALKERS)
    assert (kernel.WALK, kernel.WINDOW) == (WALK, WINDOW)
    assert (int(const("kRing")), int(const("kStats"))) == (kernel.RING,
                                                         kernel.STATS)
    # MAX_TIERS follows repro_relaxed_smem's words: 4 an entry, 64 spare
    assert "(4 * static_cast<int64_t>(kRing) + 64 +" in src
    # warps 0-3 walk; the producers are the later warps that do not share
    # warp 0's scheduler (w % 4 != 0)
    assert producers == 32 * sum(w % 4 != 0 for w in range(walkers, warps))
