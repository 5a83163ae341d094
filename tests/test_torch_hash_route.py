"""The port's hash route against the JAX reference, bit for bit.

The same numpy positions (negative and large ones included) go through
``repro.kernels.hash_route.hash_route_ref``, ``hash_route_pallas(
interpret=True)`` and the port's ``hash_route`` on CPU tensors.  Owners
and counts are integers: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.hash_route import hash_route_pallas
from repro.kernels.hash_route import hash_route_ref as j_hash_route_ref

from repro_torch.kernels.hash_route import hash_route, hash_route_ref
from repro_torch.kernels.hash_route.ref import _mul32


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    pos[:6] = [0, -1, 2 ** 31 - 1, -2 ** 31, 1, 123456789]
    return pos, rng.random(n) < 0.9


@pytest.mark.parametrize("n_shards", [1, 5, 48, 64])
def test_hash_route_matches_jax_ref(n_shards):
    pos, valid = _inputs(3000, n_shards)
    jo, jc = j_hash_route_ref(jnp.asarray(pos), jnp.asarray(valid), n_shards)
    to, tc = hash_route(torch.from_numpy(pos), torch.from_numpy(valid),
                        n_shards)
    assert to.dtype == torch.int32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n_shards", [6, 64])
def test_hash_route_matches_pallas_interpret(n_shards):
    pos, valid = _inputs(1500, 100 + n_shards)
    jo, jc = hash_route_pallas(jnp.asarray(pos), jnp.asarray(valid),
                               n_shards, interpret=True)
    to, tc = hash_route(torch.from_numpy(pos), torch.from_numpy(valid),
                        n_shards)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_mul32_keeps_low_32_bits_exactly():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2 ** 32, 10000, dtype=np.uint64)
    x[:3] = [0, 2 ** 32 - 1, 2 ** 31]
    for m in (0x7FEB352D, 0x846CA68B):
        want = (x * np.uint64(m)) & np.uint64(0xFFFFFFFF)   # wraps mod 2^64
        got = _mul32(torch.from_numpy(x.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hash_route_is_plain_on_cpu_tensors():
    pos, valid = _inputs(100, 9)
    before = hash_route.launches
    out = hash_route(torch.from_numpy(pos), torch.from_numpy(valid), 8)
    ref = hash_route_ref(torch.from_numpy(pos), torch.from_numpy(valid), 8)
    assert hash_route.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_hash_route_grid_matches_the_cuda_source():
    """The launcher's constants are hash_route.cu's, and its grid, all one
    cluster: the least power of two that covers n at VEC elements a
    thread, at most MAX_CLUSTER."""
    import re
    from pathlib import Path
    from repro_torch.kernels.hash_route import kernel
    src = (Path(kernel.__file__).parents[1] / "csrc" / "hash_route.cu"
           ).read_text()
    for name, value in (("kThreads", kernel.THREADS), ("kVec", kernel.VEC),
                        ("kMaxCluster", kernel.MAX_CLUSTER)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
    assert kernel.MAX_SHARDS * 4 <= 48 * 1024   # no opt-in above 48 KB
    per_block = kernel.THREADS * kernel.VEC
    assert kernel.grid_blocks(1) == 1
    assert kernel.grid_blocks(per_block) == 1
    assert kernel.grid_blocks(per_block + 1) == 2
    assert kernel.grid_blocks(39_102) == 16
    assert kernel.grid_blocks(65_536) == 65_536 // per_block
    assert kernel.grid_blocks(1 << 24) == kernel.MAX_CLUSTER
