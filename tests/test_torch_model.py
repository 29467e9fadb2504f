"""Reduced OLMo in the port against the reference: the same parameters (via
``interop``) and tokens give the same logits, loss and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model
from repro_torch.tree import tree_leaves

JCFG = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=32)
TCFG = reduced(get_config("olmo-1b").model, max_seq_len=32)


@pytest.fixture(scope="module")
def setup():
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), JCFG))
    tokens = np.random.RandomState(0).randint(
        0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    return params, tokens


def test_interop_round_trip_keeps_structure(setup):
    params, _ = setup
    t = params_from_numpy(params, "cpu")
    assert t["final_norm"] == {} and t["blocks"][0]["norm1"] == {}
    assert len(tree_leaves(t)) == len(jax.tree_util.tree_leaves(params)) == 15
    back = params_to_numpy(t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def _jax_loss(p, tokens):
    return jax_model.lm_loss(p, {"tokens": tokens}, JCFG)


def test_logits_and_loss_match(setup):
    params, tokens = setup
    logits_j = jax.jit(lambda p, t: jax_model.forward(
        p, {"tokens": t}, JCFG)[0])(params, tokens)
    loss_j, aux_j = jax.jit(_jax_loss)(params, tokens)
    tp = params_from_numpy(params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits_t, _ = torch_model.forward(tp, batch, TCFG)
        loss_t, aux_t = torch_model.lm_loss(tp, batch, TCFG)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["ce_loss"]),
                               float(aux_j["ce_loss"]), rtol=1e-5)


def test_grads_match(setup):
    params, tokens = setup

    grads_j = jax.jit(jax.grad(lambda p, t: _jax_loss(p, t)[0]))(params,
                                                               tokens)
    tp = params_from_numpy(params, "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    loss, _ = torch_model.lm_loss(tp, {"tokens": torch.from_numpy(tokens)},
                                  TCFG)
    grads_t = torch.autograd.grad(loss, leaves)
    for g_t, g_j in zip(grads_t, jax.tree_util.tree_leaves(grads_j)):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_apply_rope_half_split(frac):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 4, 32).astype(np.float32)
    pos = np.tile(np.arange(8, dtype=np.int32)[None] + 3, (2, 1))
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                                 frac)
    got = torch_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  10000.0, frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_nonparametric_layernorm():
    assert torch_layers.init_norm(prng.prng_key(0), TCFG, 128,
                                  device="cpu") == {}
    x = np.random.RandomState(2).randn(2, 5, 128).astype(np.float32) * 3 + 1
    want = jax_layers.norm_forward({}, jnp.asarray(x), JCFG)
    got = torch_layers.norm_forward({}, torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_port_init_has_reference_shapes():
    tp = torch_model.init_params(0, TCFG, device="cpu")
    jp = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0),
                                                      JCFG))
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jp)]
    assert torch_model.param_count(tp) == 393_216


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_model.init_params(0, TCFG)


INIT_ARCHS = ["olmo-1b", "minicpm-2b", "glm4-9b", "qwen2.5-14b"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_init_params_draws_the_reference_init(arch, seed):
    """Each leaf of ``init_params(seed)`` equals the reference's
    ``init_params(PRNGKey(seed))`` at the reduced widths, within
    ``prng.normal``'s bound (rtol 5e-7, three f32 ulps); zero biases and
    unit norm scales exactly."""
    jcfg = jax_reduced(jax_get_config(arch).model, max_seq_len=32)
    tcfg = reduced(get_config(arch).model, max_seq_len=32)
    want = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    got = torch_model.init_params(seed, tcfg, device="cpu")
    assert jax.tree_util.tree_structure(params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)
