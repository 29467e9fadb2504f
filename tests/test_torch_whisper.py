"""Whisper's layers and model against the reference at the reduced widths:
the sinusoidal table, the GELU MLP, the encoder tower, cross attention,
the forward and loss over frames with their gradients, decode fed the
encoder's output against the reference's and against the port's own
forward, and greedy generation with ``extra_batch``.

Tolerances: the sinusoidal table within 1 f32 ulp (the same f32 power,
quotient, sine and cosine); the GELU MLP and the encoder rtol 1e-5, atol
1e-6 (the tanh form on both sides); logits and loss rtol 1e-5, gradients
rtol 1e-4 and atol 1e-6 of the leaf's largest magnitude; decode logits
against the reference's rtol = atol = 1e-5 and against the port's own
forward at the reference's bounds (rtol 1e-3, atol 5e-4,
``tests/test_models.py::test_decode_matches_forward``); generated tokens
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model
from repro_torch.models import transformer as torch_transformer
from repro_torch.tree import tree_leaves

ARCH = "whisper-medium"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jax_reduced(jax_get_config(ARCH).model, max_seq_len=64),
            reduced(get_config(ARCH).model, max_seq_len=64))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed), jcfg))


def _frames(cfg, B, seed):
    return (0.1 * np.random.RandomState(seed).randn(
        B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("n_pos,d", [(1500, 1024), (32, 128), (7, 6)])
def test_sinusoidal_embedding_within_one_ulp(n_pos, d):
    want = np.asarray(jax_layers.sinusoidal_embedding(n_pos, d))
    got = torch_layers.sinusoidal_embedding(n_pos, d).numpy()
    assert got.shape == want.shape == (n_pos, d) and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_decode_position_is_the_tables_row():
    """decode's learned position at index i is row i of the table."""
    table = torch_layers.sinusoidal_embedding(40, 1024)
    for i in (0, 1, 39):
        assert torch.equal(torch_layers.sinusoids(
            torch.tensor([i], dtype=torch.int32), 1024)[0], table[i])


def test_gelu_mlp_matches_reference():
    jcfg, tcfg = _cfgs()
    want_p = jax_layers.init_mlp(jax.random.PRNGKey(3), jcfg)
    got_p = torch_layers.init_mlp(prng.prng_key(3), tcfg, device="cpu")
    assert set(got_p) == {"w_up", "w_down"}
    assert set(got_p["w_up"]) == set(got_p["w_down"]) == {"w", "b"}
    for a, b in zip(tree_leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)
    rng = np.random.RandomState(4)
    p = jax.tree_util.tree_map(np.asarray, want_p)
    p["w_up"]["b"] = rng.randn(*p["w_up"]["b"].shape).astype(np.float32)
    p["w_down"]["b"] = rng.randn(*p["w_down"]["b"].shape).astype(np.float32)
    x = (2.0 * rng.randn(2, 9, jcfg.d_model)).astype(np.float32)
    want = jax_layers.mlp_forward(p, jnp.asarray(x), jcfg)
    got = torch_layers.mlp_forward(params_from_numpy(p, "cpu"),
                                   torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_encoder_matches_reference():
    jcfg, tcfg = _cfgs()
    want_p = jax_transformer.init_encoder(jax.random.PRNGKey(5), jcfg)
    got_p = torch_transformer.init_encoder(prng.prng_key(5), tcfg,
                                           device="cpu")
    assert jax.tree_util.tree_structure(params_to_numpy(got_p)) == \
        jax.tree_util.tree_structure(want_p)
    for a, b in zip(tree_leaves(got_p), jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)
    frames = _frames(jcfg, 2, seed=6)
    p = jax.tree_util.tree_map(np.asarray, want_p)
    want = jax_transformer.encoder_forward(p, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        got = torch_transformer.encoder_forward(
            params_from_numpy(p, "cpu"), torch.from_numpy(frames), tcfg)
    assert got.shape == (2, jcfg.encoder.n_frames, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cross_attention_block_keys():
    """Each decoder block carries its cross-attention and norm; the
    encoder its blocks and final norm."""
    _, tcfg = _cfgs()
    tp = torch_model.init_params(0, tcfg, device="cpu")
    assert set(tp) == {"embed", "final_norm", "blocks", "encoder"}
    for blk in tp["blocks"]:
        assert set(blk) == {"norm1", "attn", "norm2", "mlp", "cross",
                            "cross_norm"}
        assert set(blk["cross"]) == {"wq", "wk", "wv", "wo"}
    assert len(tp["encoder"]["blocks"]) == tcfg.encoder.n_layers


def test_logits_and_loss_match():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    batch = {"tokens": _tokens(jcfg, 2, 24, seed=1),
             "frames": _frames(jcfg, 2, seed=2)}
    logits_j, _ = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg))(
        params, batch)
    loss_j, _ = jax.jit(lambda p, b: jax_model.lm_loss(p, b, jcfg))(
        params, batch)
    tp = params_from_numpy(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits_t, aux = torch_model.forward(tp, tb, tcfg)
        loss_t, _ = torch_model.lm_loss(tp, tb, tcfg)
    assert logits_t.shape == (2, 24, jcfg.vocab_size) and aux == {}
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_forward_needs_frames():
    _, tcfg = _cfgs()
    tp = torch_model.init_params(0, tcfg, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        torch_model.forward(
            tp, {"tokens": torch.zeros(1, 4, dtype=torch.int32)}, tcfg)


def test_grads_match():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=2)
    batch = {"tokens": _tokens(jcfg, 2, 16, seed=3),
             "frames": _frames(jcfg, 2, seed=4)}
    grads_j = jax.jit(jax.grad(lambda p, b: jax_model.lm_loss(
        p, b, jcfg)[0]))(params, batch)
    tp = params_from_numpy(params, "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    loss, _ = torch_model.lm_loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    grads_t = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(grads_t) == len(want)
    for g_t, g_j in zip(grads_t, want):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(g_j).max()))


def test_decode_matches_reference_and_forward():
    """Decode fed ``encoder_out`` against the reference's decode and
    against the port's forward over ``frames``."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=3)
    B, S = 2, 12
    toks, frames = _tokens(jcfg, B, S, seed=4), _frames(jcfg, B, seed=5)
    enc_j = jax_transformer.encoder_forward(params["encoder"],
                                            jnp.asarray(frames), jcfg)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        enc_t = torch_transformer.encoder_forward(
            tp["encoder"], torch.from_numpy(frames), tcfg)
        full, _ = torch_model.forward(
            tp, {"tokens": torch.from_numpy(toks),
                 "frames": torch.from_numpy(frames)}, tcfg)
    jc = jax_model.init_caches(jcfg, B, S, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, B, S, dtype=torch.float32,
                                 device="cpu")
    jstep = jax.jit(lambda p, b, c: jax_model.decode_step(p, b, c, jcfg))
    for t in range(S):
        lj, jc = jstep(params, {"tokens": toks[:, t:t + 1],
                                "encoder_out": enc_j}, jc)
        with torch.no_grad():
            lt, tc = torch_model.decode_step(
                tp, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                     "encoder_out": enc_t}, tc, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-3, atol=5e-4, err_msg=f"step {t}")


def test_generate_with_extra_batch_identical_to_reference():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=5)
    prompt = _tokens(jcfg, 2, 6, seed=6)
    frames = _frames(jcfg, 2, seed=7)
    enc_j = jax_transformer.encoder_forward(params["encoder"],
                                            jnp.asarray(frames), jcfg)
    want = np.asarray(jax_serve.generate(jcfg, params, jnp.asarray(prompt), 6,
                                         extra_batch={"encoder_out": enc_j}))
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        enc_t = torch_transformer.encoder_forward(
            tp["encoder"], torch.from_numpy(frames), tcfg)
    got = torch_serve.generate(tcfg, tp, torch.from_numpy(prompt), 6,
                               extra_batch={"encoder_out": enc_t})
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs_on_cpu(capsys):
    out = torch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                            "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 7)
    assert f"[{ARCH}] generated 6 tokens" in capsys.readouterr().out
