"""The port's threefry key stream against ``jax.random``, bit for bit:
keys, ``fold_in``, ``split``, the replica keys of the QSGD programs and
the uniforms of the stochastic rounding; the normals of the CNN's
initial parameters to rtol 5e-7 (XLA's ``erf_inv`` polynomial over a
``log1p`` that rounds differently: at most 3 ulps, relative 2.4e-7,
measured)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qsgd as jax_qsgd
from repro_torch.core import prng


def _pair(key):
    return tuple(int(v) for v in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 1, 17, 12345, 2**31 - 1])
def test_prng_key(seed):
    assert prng.prng_key(seed) == _pair(jax.random.PRNGKey(seed))


def test_prng_key_rejects_out_of_range():
    with pytest.raises(ValueError):
        prng.prng_key(-1)


@pytest.mark.parametrize("data", [0, 1, 7, 2**20 + 3, 2**32 - 1])
def test_fold_in(data):
    jk, tk = jax.random.PRNGKey(17), prng.prng_key(17)
    for d in (data, 3, data):
        jk, tk = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
        assert tk == _pair(jk)


@pytest.mark.parametrize("n", [1, 2, 15, 29])
def test_split(n):
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    got = prng.split(_pair(jk), n)
    assert got == [_pair(k) for k in jax.random.split(jk, n)]


def test_replica_keys_match_reference():
    jk = jax.random.fold_in(jax.random.PRNGKey(17), 5)
    want = jax_qsgd.replica_keys(jk, jnp.arange(4))
    assert prng.replica_keys(_pair(jk), range(4)) == \
        [_pair(k) for k in want]


def test_engine_key_stream():
    """The key the engine hands program j of iteration k."""
    base = jax.random.PRNGKey(0 + 17)
    for k, j in ((0, 0), (0, 1), (5, 1), (15, 0)):
        want = jax.random.fold_in(jax.random.fold_in(base, k), j)
        got = prng.fold_in(prng.fold_in(prng.prng_key(17), k), j)
        assert got == _pair(want)


@pytest.mark.parametrize("shape", [(7,), (1000,), (33, 17), (2, 3, 5),
                                   (4, 130, 129)])
def test_uniform_bit_identical(shape):
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), 2), 4)[3]
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(_pair(jk), shape, device="cpu")
    assert tuple(got.shape) == shape and got.dtype.is_floating_point
    assert got.numpy().dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("shape", [(7,), (3, 3, 3, 16), (3, 3, 16, 32),
                                   (2048, 256), (4, 130, 129)])
def test_normal_matches_reference(shape):
    jk = jax.random.split(jax.random.PRNGKey(3), 5)[4]
    want = np.asarray(jax.random.normal(jk, shape))
    got = prng.normal(_pair(jk), shape, device="cpu")
    assert tuple(got.shape) == shape and got.numpy().dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)


@pytest.mark.parametrize("fn", ["uniform", "normal"])
@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_chunked_draw_bit_identical(fn, chunk, monkeypatch):
    """A draw made ``chunk`` elements at a time is ``jax.random``'s draw
    (each element's counter is its index, wherever its chunk starts):
    the chunked uniforms under ``normal`` bit for bit, the normals within
    ``normal``'s bound."""
    monkeypatch.setattr(prng, "CHUNK", chunk)
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = np.asarray(getattr(jax.random, fn)(jk, (33, 17)))
    if fn == "uniform":
        got = prng._draw(_pair(jk), (33, 17), "cpu", lambda u: u)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    else:
        got = prng.normal(_pair(jk), (33, 17), device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)
    assert tuple(got.shape) == (33, 17)
