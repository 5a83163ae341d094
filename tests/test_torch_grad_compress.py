"""The port's int8 + error-feedback gradient compression against the JAX
package: the reference's three cases (``tests/test_grad_compress.py``)
in torch form, and the int8 payload, its scales and the residual on the
same numpy gradients.  Rounding is half to even in both packages, so the
int8 blocks are identical; the f32 scales and residuals are the same
f32 operations in the same order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.train.grad_compress import compress_grads as j_compress
from repro.train.grad_compress import compression_ratio as j_ratio

from repro_torch.train.grad_compress import (BLOCK, compress_grads,
                                             compression_ratio,
                                             decompress_grads)
from repro_torch.tree import tree_leaves


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((256, 128)) * 0.01).astype(np.float32),
            "b": {"w": rng.standard_normal((1000,)).astype(np.float32)}}


def _tree(seed=0):
    return {"a": torch.from_numpy(_np_tree(seed)["a"]),
            "b": {"w": torch.from_numpy(_np_tree(seed)["b"]["w"])}}


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def test_roundtrip_error_bounded():
    g = _tree()
    payload, _ = compress_grads(g, None)
    deq = decompress_grads(payload, g)
    for x, y in zip(tree_leaves(g), tree_leaves(deq)):
        scale = float(x.abs().max()) / 127
        assert float((x - y).abs().max()) <= scale * 1.01


def test_error_feedback_unbiased_over_time():
    """Accumulated (dequantized) updates converge to accumulated grads."""
    g = _tree(1)
    res = None
    total_true = _map(torch.zeros_like, g)
    total_sent = _map(torch.zeros_like, g)
    for step in range(30):
        gs = _map(lambda x: x * (1 + 0.01 * step), g)
        payload, res = compress_grads(gs, res)
        deq = decompress_grads(payload, gs)
        total_true = _map(lambda a, b: a + b, total_true, gs)
        total_sent = _map(lambda a, b: a + b, total_sent, deq)
    for t, s, r in zip(tree_leaves(total_true), tree_leaves(total_sent),
                       tree_leaves(res)):
        # residual carries exactly the un-sent mass: true = sent + residual
        np.testing.assert_allclose(t.numpy(), (s + r).numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_compression_ratio():
    r = compression_ratio(_tree(2))
    assert 0.4 < r < 0.6  # ~int8 + block scales vs bf16
    t = _np_tree(2)
    assert r == pytest.approx(j_ratio({"a": jnp.asarray(t["a"]),
                                       "b": {"w": jnp.asarray(t["b"]["w"])}}))


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_payload_identical_to_jax(seed):
    """Three steps with error feedback from bf16 and f32 gradients: every
    int8 block is the reference's exactly, the scales and residuals too
    (the same f32 operations)."""
    rng = np.random.default_rng(seed)
    jres = tres = None
    for step in range(3):
        a = (rng.standard_normal((37, 300)) * 0.02).astype(np.float32)
        w = rng.standard_normal((2 * BLOCK + 5,)).astype(np.float32)
        jg = {"a": jnp.asarray(a, jnp.bfloat16), "b": {"w": jnp.asarray(w)}}
        tg = {"a": torch.from_numpy(a).to(torch.bfloat16),
              "b": {"w": torch.from_numpy(w)}}
        assert np.array_equal(np.asarray(jg["a"]).astype(np.float32),
                              tg["a"].float().numpy())
        jpay, jres = j_compress(jg, jres)
        tpay, tres = compress_grads(tg, tres)
        for (jq, js), (tq, ts) in zip(
                [jpay["a"], jpay["b"]["w"]], [tpay["a"], tpay["b"]["w"]]):
            assert tq.dtype == torch.int8 and ts.dtype == torch.float32
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tres["a"].numpy(),
                                      np.asarray(jres["a"]))
        np.testing.assert_array_equal(tres["b"]["w"].numpy(),
                                      np.asarray(jres["b"]["w"]))
