"""The port's QSGD kernels (sqnorm, quantize, dequantize) against the
reference, on the cases of ``tests/test_kernels.py``; the keyed quantize's
CPU route against the plain version with ``prng.uniform``'s draw.

On the CPU each wrapper takes its plain version; it is held against the
Pallas kernels in interpret mode and the reference's jnp oracle with the
same uniforms: levels exactly, norms to rtol 1e-6 (f32 sums in another
order), dequantized values to rtol 1e-6.  The CUDA kernels themselves run
only on the card (``tests/test_torch_kernels_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import qsgd_quant as jax_qq
from repro_torch.core import prng
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops as torch_ops
from repro_torch.kernels import qsgd_quant
from repro_torch.kernels import ref as torch_ref


def _xu(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0).astype(np.float32)
    return x, rng.uniform(size=shape).astype(np.float32)


def _quantize(x, u, bits):
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    norm = torch.sqrt(torch_ops.qsgd_sqnorm(xt))
    return torch_ops.qsgd_quantize(xt, ut, norm, bits), norm


@pytest.mark.parametrize("n", [7, 1000, 1024, 4097])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_matches_pallas_and_jnp_oracle(n, bits):
    x, u = _xu((n,), n)
    lv, nm = _quantize(x, u, bits)
    lv_pl, nm_pl = jax_qq.quantize(jnp.asarray(x), jnp.asarray(u), bits=bits,
                                   interpret=True)
    lv_or, nm_or = jax_ref.quantize_ref(jnp.asarray(x), jnp.asarray(u),
                                        bits=bits)
    assert lv.dtype == torch.int8 and lv.shape == (n,)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_or))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_pl))
    for want in (nm_pl, nm_or):
        np.testing.assert_allclose(float(nm), float(want), rtol=1e-6)
    sq_pl = jax_qq.sqnorm(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(float(torch_ops.qsgd_sqnorm(
        torch.from_numpy(x))), float(sq_pl), rtol=1e-6)
    dq = torch_ops.qsgd_dequantize(lv, nm, bits)
    dq_pl = jax_qq.dequantize(lv_pl, nm_pl, bits=bits, interpret=True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_pl), rtol=1e-6)
    np.testing.assert_allclose(
        dq.numpy(), np.asarray(jax_ref.dequantize_ref(lv_or, nm_or,
                                                      bits=bits)), rtol=1e-6)
    # quantization error bound: |q - x| <= norm / s elementwise
    s = (1 << (bits - 1)) - 1
    assert float((dq - torch.from_numpy(x)).abs().max()) <= \
        float(nm) / s + 1e-6


def test_multidim_and_zero():
    x, u = _xu((33, 17), 3)
    lv, nm = _quantize(x, u, 8)
    lv_or, nm_or = jax_ref.quantize_ref(jnp.asarray(x), jnp.asarray(u))
    assert lv.shape == (33, 17)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_or))
    lvz, nmz = _quantize(np.zeros(128, np.float32), np.zeros(128, np.float32),
                         8)
    assert float(nmz) == 0.0 and int(lvz.abs().max()) == 0
    assert not torch_ops.qsgd_dequantize(lvz, nmz).any()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_level_above_s_saturates_as_jnp_does(sign):
    """A norm just below |x| makes |x| / norm · s round above s; with
    u = 0 the level is s + 1 = 128, which XLA's cast saturates to 127
    (and -128 stays -128).  The port clamps before its cast."""
    x = np.array([sign * 1.5, 0.25, -0.5], np.float32)
    u = np.zeros(3, np.float32)
    norm = np.float32(1.5) * np.float32(1 - 2**-20)
    s = 127
    scaled = jnp.where(norm > 0, jnp.abs(x) / norm * s, 0.0)
    floor = jnp.floor(scaled)
    mag = floor + (u < scaled - floor).astype(jnp.float32)
    assert float(mag[0]) == 128.0
    want = (jnp.sign(x) * mag).astype(jnp.int8)        # ref.py's cast
    got = torch_ops.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(u),
                                  torch.tensor(norm), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == (127 if sign > 0 else -128)
    assert int(jnp.float32(128.0).astype(jnp.int8)) == 127


def test_cpu_tensors_take_plain_versions_without_launch():
    x, u = (torch.from_numpy(a) for a in _xu((300,), 5))
    before = (qsgd_quant.sqnorm.launches, qsgd_quant.quantize.launches,
              qsgd_quant.dequantize.launches)
    sq = torch_ops.qsgd_sqnorm(x)
    norm = torch.sqrt(sq)
    lv = torch_ops.qsgd_quantize(x, u, norm, 8)
    dq = torch_ops.qsgd_dequantize(lv, norm, 8)
    assert (qsgd_quant.sqnorm.launches, qsgd_quant.quantize.launches,
            qsgd_quant.dequantize.launches) == before
    lv_ref, norm_ref = torch_ref.quantize_ref(x, u, 8)
    assert torch.equal(sq, torch_ref.sqnorm_ref(x))
    assert torch.equal(lv, lv_ref) and torch.equal(norm, norm_ref)
    assert torch.equal(dq, torch_ref.dequantize_ref(lv_ref, norm_ref, 8))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64,
                                   torch.bfloat16])
def test_wrappers_reject_other_dtypes(dtype):
    x = torch.ones(16, dtype=dtype)
    norm = torch.ones(())
    with pytest.raises(TypeError):
        torch_ops.qsgd_sqnorm(x)
    with pytest.raises(TypeError):
        torch_ops.qsgd_quantize(x, torch.zeros(16), norm)
    with pytest.raises(TypeError):
        torch_ops.qsgd_dequantize(x, norm)


def test_wrappers_reject_strided_input():
    x = torch.randn(8, 4).T
    norm = torch.ones(())
    with pytest.raises(ValueError, match="contiguous"):
        torch_ops.qsgd_sqnorm(x)
    with pytest.raises(ValueError, match="contiguous"):
        torch_ops.qsgd_quantize(x, torch.zeros(4, 8).T, norm)
    with pytest.raises(ValueError, match="contiguous"):
        torch_ops.qsgd_dequantize(torch.zeros(8, 4, dtype=torch.int8).T,
                                  norm)


def test_wrappers_reject_mismatched_inputs():
    x = torch.randn(16)
    with pytest.raises(ValueError, match="u must match"):
        torch_ops.qsgd_quantize(x, torch.zeros(15), torch.ones(()))
    with pytest.raises(ValueError, match="norm"):
        torch_ops.qsgd_quantize(x, torch.zeros(16), torch.ones(2))
    with pytest.raises(ValueError, match="bits"):
        torch_ops.qsgd_dequantize(torch.zeros(4, dtype=torch.int8),
                                  torch.ones(()), bits=9)


def test_port_follows_the_jnp_formula_not_the_pallas_body():
    """The Pallas body computes |x| · (s / norm), which rounds differently
    from the jnp oracle's |x| / norm · s.  With each u equal to its
    element's fraction under the jnp formula, the two disagree on some
    levels (14 of 4097 here); the port equals the jnp oracle on all."""
    x, _ = _xu((4097,), 11)
    norm = np.float32(np.sqrt(np.sum(np.square(x, dtype=np.float32),
                                     dtype=np.float32)))
    scaled = (np.abs(x) / norm * np.float32(127)).astype(np.float32)
    u = (scaled - np.floor(scaled)).astype(np.float32)   # u == frac
    lv_or, nm_or = jax_ref.quantize_ref(jnp.asarray(x), jnp.asarray(u))
    lv_pl, nm_pl = jax_qq.quantize(jnp.asarray(x), jnp.asarray(u),
                                   interpret=True)
    assert float(nm_pl) == float(nm_or)
    assert int((np.asarray(lv_pl) != np.asarray(lv_or)).sum()) > 0
    lv = torch_ops.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(u),
                                 torch.tensor(float(nm_or)), 8)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_or))


def test_sqnorm_many_plain_route_matches_pallas_per_tensor():
    """A mixed group through ``sqnorm_many``'s plain route against the
    reference's Pallas ``sqnorm`` in interpret mode, tensor by tensor
    (rtol 1e-6: f32 sums in another order), and against ``sqnorm`` of each
    tensor alone, bit for bit."""
    xs = [_xu(s, i)[0] for i, s in enumerate(((7,), (1000,), (1024,),
                                             (4097,), (33, 17), (1,)))]
    got = torch_ops.qsgd_sqnorm_many([torch.from_numpy(x) for x in xs])
    assert got.shape == (len(xs),) and got.dtype == torch.float32
    for g, x in zip(got, xs):
        want = jax_qq.sqnorm(jnp.asarray(x), interpret=True)
        np.testing.assert_allclose(float(g), float(want), rtol=1e-6)
        assert torch.equal(g, torch_ops.qsgd_sqnorm(torch.from_numpy(x)))


def test_sqnorm_many_cpu_route_counts_no_launch():
    xs = [torch.randn(n) for n in (5, 64, 130)]
    before = qsgd_quant.sqnorm.launches
    got = qsgd_quant.sqnorm_many(xs)
    assert qsgd_quant.sqnorm.launches == before
    assert torch.equal(got, torch_ref.sqnorm_many_ref(xs))
    assert torch.equal(got, torch.stack([torch_ref.sqnorm_ref(x)
                                         for x in xs]))


def test_sqnorm_many_rejects_bad_groups():
    with pytest.raises(ValueError, match="at least one"):
        qsgd_quant.sqnorm_many([])
    with pytest.raises(TypeError):
        qsgd_quant.sqnorm_many([torch.ones(4),
                                torch.ones(4, dtype=torch.int32)])
    with pytest.raises(ValueError, match="contiguous"):
        qsgd_quant.sqnorm_many([torch.ones(4), torch.randn(8, 4).T])


@pytest.mark.parametrize("shape", [(7,), (1000,), (4097,), (33, 17),
                                   (5, 4, 3)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_keyed_cpu_route_is_plain_with_prng_uniform(shape, bits):
    """On the CPU the keyed quantize is ``quantize_ref`` with
    ``prng.uniform(key, shape)``, bit for bit, and launches nothing."""
    x = torch.from_numpy(_xu(shape, len(shape) * 10 + bits)[0])
    key = prng.split(prng.fold_in(prng.prng_key(2**31 + 5), bits), 4)[3]
    norm = torch.sqrt(torch_ops.qsgd_sqnorm(x))
    before = qsgd_quant.quantize_keyed.launches
    lv = torch_ops.qsgd_quantize_keyed(x, key, norm, bits)
    assert qsgd_quant.quantize_keyed.launches == before
    want, _ = torch_ref.quantize_ref(x, prng.uniform(key, shape), bits,
                                     norm=norm)
    assert lv.dtype == torch.int8 and torch.equal(lv, want)
    assert torch.equal(lv, torch_ops.qsgd_quantize(
        x, prng.uniform(key, shape), norm, bits))


def test_quantize_keyed_rejects_bad_inputs():
    x, key = torch.randn(16), (0, 5)
    with pytest.raises(TypeError):
        qsgd_quant.quantize_keyed(x.double(), key, torch.ones(()))
    with pytest.raises(ValueError, match="contiguous"):
        qsgd_quant.quantize_keyed(torch.randn(8, 4).T, key, torch.ones(()))
    with pytest.raises(ValueError, match="norm"):
        qsgd_quant.quantize_keyed(x, key, torch.ones(2))
    with pytest.raises(ValueError, match="key words"):
        qsgd_quant.quantize_keyed(x, (0, 1 << 32), torch.ones(()))
    with pytest.raises(ValueError, match="bits"):
        qsgd_quant.quantize_keyed(x, key, torch.ones(()), bits=9)
