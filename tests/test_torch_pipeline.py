"""Synthetic token batches: bit-identical to the reference's, across an
epoch boundary."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro_torch.data.pipeline import SyntheticTokens


@pytest.mark.parametrize("seed", [0, 3])
def test_token_batches_bit_identical_across_epochs(seed):
    R, b = 4, 4
    kw = dict(vocab_size=512, seq_len=32, n_samples=R * b * 3, seed=seed)
    mine = SyntheticTokens(**kw).batches(n_replicas=R, per_replica_batch=b,
                                         device="cpu")
    ref = JaxTokens(**kw).batches(n_replicas=R, per_replica_batch=b)
    assert mine.steps_per_epoch == 3
    for step in range(8):                   # epochs 0, 1 and 2
        got, want = mine(step)["tokens"], np.asarray(ref(step)["tokens"])
        assert got.dtype == torch.int32 and got.shape == (R, b, 32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_eval_batches_bit_identical():
    mine = SyntheticTokens(128, 16, n_samples=100, seed=1)
    ref = JaxTokens(128, 16, n_samples=100, seed=1)
    got = list(mine.eval_batches(batch=32, device="cpu"))
    want = list(ref.eval_batches(batch=32))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"].numpy(),
                                      np.asarray(w["tokens"]))
