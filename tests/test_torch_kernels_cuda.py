"""The CUDA mean_and_sqdev kernel against its plain version, on the card.

Imports neither jax nor the reference, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_kernels_cuda.py

Without a CUDA device every case skips (the kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.param_variance import mean_and_sqdev

CASES = [(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3)),
         (4, (2048, 2048))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,shape", CASES)
def test_kernel_matches_plain_and_repeats_bitwise(cuda, R, shape):
    w = torch.from_numpy(
        np.random.RandomState(R).randn(R, *shape).astype(np.float32)).to(cuda)
    before = mean_and_sqdev.launches
    m, sq = mean_and_sqdev(w)
    m2, sq2 = mean_and_sqdev(w)
    torch.cuda.synchronize()
    assert mean_and_sqdev.launches == before + 2
    m_ref, sq_ref = torch_ref.mean_and_sqdev_ref(w)
    torch.testing.assert_close(m, m_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(m, m2) and torch.equal(sq, sq2)


@pytest.mark.cuda
def test_kernel_rejects_strided_input(cuda):
    w = torch.zeros(8, 4, device=cuda).T
    with pytest.raises(ValueError, match="contiguous"):
        mean_and_sqdev(w)


@pytest.mark.cuda
def test_sync_uses_kernel_on_cuda(cuda):
    from repro_torch.backends import VmapBackend
    W = {"a": torch.randn(4, 300, device=cuda), "n": {},
         "b": [torch.randn(4, 7, 5, device=cuda)]}
    want = float(sum(torch_ref.mean_and_sqdev_ref(x)[1]
                     for x in (W["a"], W["b"][0])) / 4)
    before = mean_and_sqdev.launches
    W, _, s_k = VmapBackend(device=cuda).all_mean()(W, None)
    assert mean_and_sqdev.launches == before + 2
    assert abs(float(s_k) - want) <= 1e-5 * want
    assert torch.equal(W["a"], W["a"][:1].expand_as(W["a"]))
