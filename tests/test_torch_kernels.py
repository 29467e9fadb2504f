"""The port's fused replica-mean + sqdev kernel against the reference.

On the CPU the wrapper takes the plain version; it is held against the
Pallas kernel in interpret mode and the reference's jnp oracle on the
shapes of ``tests/test_kernels.py``.  The CUDA kernel itself runs only on
the card (``tests/test_torch_kernels_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.param_variance import mean_and_sqdev as jax_mean_and_sqdev
from repro_torch.kernels import ops as torch_ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.param_variance import mean_and_sqdev

CASES = [(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3))]


def _w(R, shape, seed):
    return np.random.RandomState(seed).randn(R, *shape).astype(np.float32)


@pytest.mark.parametrize("R,shape", CASES)
def test_plain_matches_pallas_and_jnp_oracle(R, shape):
    w = _w(R, shape, R)
    m_pl, sq_pl = jax_mean_and_sqdev(jnp.asarray(w), interpret=True)
    m_or, sq_or = jax_ref.mean_and_sqdev_ref(jnp.asarray(w))
    m, sq = mean_and_sqdev(torch.from_numpy(w))
    assert m.shape == shape and m.dtype == torch.float32 and sq.shape == ()
    for m_ref, sq_ref in ((m_pl, sq_pl), (m_or, sq_or)):
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=1e-6)
        np.testing.assert_allclose(float(sq), float(sq_ref),
                                   rtol=1e-5, atol=1e-6)


def test_identical_replicas_give_zero_sqdev():
    w = np.broadcast_to(np.random.RandomState(0).randn(50), (8, 50))
    _, sq = mean_and_sqdev(torch.from_numpy(np.ascontiguousarray(w, np.float32)))
    assert float(sq) < 1e-10


def test_cpu_tensor_takes_plain_version_without_launch():
    w = torch.from_numpy(_w(4, (64,), 1))
    before = mean_and_sqdev.launches
    m, sq = torch_ops.param_mean_and_sqdev(w)
    m_ref, sq_ref = torch_ref.mean_and_sqdev_ref(w)
    assert mean_and_sqdev.launches == before
    assert torch.equal(m, m_ref) and torch.equal(sq, sq_ref)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.bfloat16])
def test_wrapper_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        mean_and_sqdev(torch.ones(4, 8, dtype=dtype))
