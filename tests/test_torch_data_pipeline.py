"""The port's data pipeline against ``repro.data.pipeline``, bit for bit on
the CPU: ``synthetic_tokens`` on sample indices up to 2^64 - 1 and vocab
sizes up to 2^31 - 1 (uint64 arithmetic held in int64), and
``GlobalOrderPipeline``'s batches, cursor, checkpointed state and worker
slices in the reference's scenarios."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import GlobalOrderPipeline as RefPipeline
from repro.data.pipeline import synthetic_tokens as ref_tokens

from repro_torch.configs import get_config
from repro_torch.data import GlobalOrderPipeline, synthetic_tokens

IDX = np.array([0, 1, 5, 9, 2 ** 31 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63,
                2 ** 64 - 1], dtype=np.uint64)


def _batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("vocab", [3, 100, 1_000, 32_000, 2 ** 31 - 1])
def test_synthetic_tokens_bit_identical(vocab):
    rng = np.random.default_rng(vocab)
    idx = np.concatenate([IDX, rng.integers(0, 2 ** 64 - 1, 64,
                                            dtype=np.uint64, endpoint=True)])
    got = synthetic_tokens(torch.from_numpy(idx.view(np.int64)), 33, vocab,
                           device="cpu")
    assert got.dtype == torch.int32 and got.shape == (idx.size, 33)
    np.testing.assert_array_equal(got.numpy(), ref_tokens(idx, 33, vocab))


def test_synthetic_tokens_pure():
    a = synthetic_tokens(np.array([5, 9]), 8, 1000, device="cpu")
    b = synthetic_tokens(np.array([9]), 8, 1000, device="cpu")
    np.testing.assert_array_equal(a[1].numpy(), b[0].numpy())
    assert bool((a >= 0).all()) and bool((a < 1000).all())


def test_zamba2_prefill_shape_bit_identical():
    """The smoke's shape: 4 x 4,097 tokens over zamba2-1.2b's vocab."""
    vocab = get_config("zamba2_1p2b").vocab
    idx = np.arange(4)
    np.testing.assert_array_equal(
        synthetic_tokens(idx, 4_097, vocab, device="cpu").numpy(),
        ref_tokens(idx, 4_097, vocab))


def test_data_pipeline_deterministic_and_elastic():
    pipe = GlobalOrderPipeline(16, 100, 8, device="cpu")
    ref = RefPipeline(16, 100, 8)
    b0, b1 = pipe.batch_at_step(3), pipe.batch_at_step(3)
    assert torch.equal(b0["tokens"], b1["tokens"])
    _batch_equal(b0, ref.batch_at_step(3))
    # elastic: union over 2 workers == single worker's global batch
    w0 = pipe.batch_at_step(5, n_workers=2, worker=0)
    w1 = pipe.batch_at_step(5, n_workers=2, worker=1)
    full = pipe.batch_at_step(5, n_workers=1, worker=0)
    assert torch.equal(torch.cat([w0["sample_indices"],
                                  w1["sample_indices"]]),
                       full["sample_indices"])
    assert torch.equal(torch.cat([w0["tokens"], w1["tokens"]]),
                       full["tokens"])
    for w, b in ((0, w0), (1, w1)):
        _batch_equal(b, ref.batch_at_step(5, n_workers=2, worker=w))


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_cursor_and_restore_equal_reference(n_workers):
    pipe = GlobalOrderPipeline(12, 1_000, 8, start_index=3, device="cpu")
    ref = RefPipeline(12, 1_000, 8, start_index=3)
    for step in range(3):
        for w in range(n_workers):
            _batch_equal(pipe.batch_at_step(step, n_workers, w),
                         ref.batch_at_step(step, n_workers, w))
        _batch_equal(pipe.next_batch(n_workers, step % n_workers),
                     ref.next_batch(n_workers, step % n_workers))
        assert pipe.state() == ref.state()
    saved = pipe.state()
    after = pipe.next_batch(n_workers, 0)
    fresh = GlobalOrderPipeline(12, 1_000, 8, device="cpu")
    fresh.restore(saved)                # a restarted run replays the stream
    again = fresh.next_batch(n_workers, 0)
    for k in after:
        assert torch.equal(after[k], again[k])
    ref.restore(saved)
    _batch_equal(again, ref.next_batch(n_workers, 0))
