"""Qwen2-VL's layers and model against the reference at the reduced widths:
M-RoPE, the vision prefix with 3D positions, the loss and its gradients,
decode against the reference's and against the port's own forward, and
greedy generation.

Tolerances: ``apply_mrope`` within 1e-6 (the angles are the same f32
products, the selection exact); logits and loss rtol 1e-5, gradients
rtol 1e-4 and atol 1e-6 of the leaf's largest magnitude (as the other
model tests); decode logits against the reference's rtol = atol = 1e-5
and against the port's own prefill at the reference's bounds (rtol 1e-3,
atol 5e-4, ``tests/test_models.py::test_decode_matches_forward``);
generated tokens exactly.
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
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model
from repro_torch.tree import tree_leaves

ARCH = "qwen2-vl-2b"


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


def mrope_grid(B, P, S, grid_w):
    """Qwen2-VL's 3D positions for P patches on a grid ``grid_w`` wide
    (t = 0, h = row, w = column) and S text tokens after them (t = h = w,
    counting on from the largest patch position), (3, B, P + S)."""
    i = np.arange(P)
    vis = np.stack([np.zeros(P), i // grid_w, i % grid_w])
    start = vis.max() + 1 if P else 0
    txt = np.tile(start + np.arange(S), (3, 1))
    pos = np.concatenate([vis, txt], axis=1).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, B, P + S)).copy()


def vlm_batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    P = cfg.vision.n_patches
    return {
        "tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "vision_embeds": (0.02 * rng.randn(B, P, cfg.d_model)).astype(
            np.float32),
        "mrope_pos": mrope_grid(B, P, S, grid_w=4),
    }


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dh,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(dh, sections):
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 24, 4, dh).astype(np.float32)
    pos3 = rng.randint(0, 64, (3, 2, 24)).astype(np.int32)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                                  sections)
    got = torch_layers.apply_mrope(torch.from_numpy(x),
                                   torch.from_numpy(pos3), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_apply_mrope_with_equal_rows_is_rope():
    """t = h = w turns every slot by the one position: plain RoPE."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 10, 4, 128).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 500, (2, 10)).astype(np.int32))
    got = torch_layers.apply_mrope(x, pos[None].expand(3, 2, 10), 1e6,
                                   (16, 24, 24))
    assert torch.equal(got, torch_layers.apply_rope(x, pos, 1e6))


def test_apply_mrope_refuses_sections_that_miss_dh():
    x = torch.zeros(1, 2, 1, 32)
    with pytest.raises(ValueError, match="sections"):
        torch_layers.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32),
                                 1e6, (4, 6, 4))


@pytest.mark.parametrize("with_prefix", [True, False])
def test_logits_and_loss_match(with_prefix):
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    batch = vlm_batch(jcfg, 2, 24, seed=1)
    if not with_prefix:
        batch = {"tokens": batch["tokens"]}
    logits_j, _ = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg))(
        params, batch)
    loss_j, _ = jax.jit(lambda p, b: jax_model.lm_loss(p, b, jcfg))(
        params, batch)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        logits_t, aux = torch_model.forward(tp, to_torch(batch), tcfg)
        loss_t, _ = torch_model.lm_loss(tp, to_torch(batch), tcfg)
    S = 24 + (jcfg.vision.n_patches if with_prefix else 0)
    assert logits_t.shape == (2, S, jcfg.vocab_size) and aux == {}
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_prefix_is_unscaled_and_unscored():
    """``emb_scale`` scales the tokens' embeddings and not the prefix;
    positions run over the prefixed sequence; the loss scores the logits
    after the prefix only."""
    import dataclasses
    _, tcfg = _cfgs()
    tp = torch_model.init_params(0, tcfg, device="cpu")
    batch = to_torch(vlm_batch(tcfg, 1, 8, seed=2))
    x, pos, mrope = torch_model._embed_inputs(tp, batch, tcfg)
    x2, _, _ = torch_model._embed_inputs(
        tp, batch, dataclasses.replace(tcfg, emb_scale=2.0))
    P = tcfg.vision.n_patches
    assert torch.equal(x[:, :P], x2[:, :P])
    assert torch.equal(2.0 * x[:, P:], x2[:, P:])
    assert tuple(pos.shape) == (1, P + 8) and mrope is batch["mrope_pos"]
    with torch.no_grad():
        logits, _ = torch_model.forward(tp, batch, tcfg)
        loss, _ = torch_model.lm_loss(tp, batch, tcfg)
    lg = logits[:, P:-1].float()
    want = (torch.logsumexp(lg, -1) - lg.gather(
        -1, batch["tokens"][:, 1:, None].long())[..., 0]).mean()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def test_grads_match_with_prefix():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=2)
    batch = vlm_batch(jcfg, 2, 16, seed=3)
    grads_j = jax.jit(jax.grad(lambda p, b: jax_model.lm_loss(
        p, b, jcfg)[0]))(params, batch)
    tp = params_from_numpy(params, "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    loss, _ = torch_model.lm_loss(tp, to_torch(batch), tcfg)
    grads_t = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(grads_t) == len(want) == 2 + 2 * 12
    for g_t, g_j in zip(grads_t, want):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(g_j).max()))


@pytest.mark.parametrize("with_mrope", [False, True])
def test_decode_matches_reference_and_forward(with_mrope):
    """Text-only decode (the reference's own test: t = h = w), and decode
    fed 3D positions step by step, each against the reference's decode
    and the port's forward over the whole sequence."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=3)
    B, S = 2, 12
    toks = np.random.RandomState(4).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    mrope = mrope_grid(B, 0, S, 4) + np.array([0, 3, 5])[:, None, None]
    full_batch = {"tokens": toks}
    if with_mrope:
        full_batch["mrope_pos"] = mrope.astype(np.int32)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        full, _ = torch_model.forward(tp, to_torch(full_batch), tcfg)
    jc = jax_model.init_caches(jcfg, B, S, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, B, S, dtype=torch.float32,
                                 device="cpu")
    jstep = jax.jit(lambda p, b, c: jax_model.decode_step(p, b, c, jcfg))
    for t in range(S):
        b = {"tokens": toks[:, t:t + 1]}
        if with_mrope:
            b["mrope_pos"] = mrope[:, :, t:t + 1].astype(np.int32)
        lj, jc = jstep(params, b, jc)
        with torch.no_grad():
            lt, tc = torch_model.decode_step(tp, to_torch(b), tc, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-3, atol=5e-4, err_msg=f"step {t}")


def test_generate_tokens_identical_to_reference():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=5)
    prompt = np.random.RandomState(6).randint(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jax_serve.generate(jcfg, params, jnp.asarray(prompt), 6))
    got = torch_serve.generate(tcfg, params_from_numpy(params, "cpu"),
                               torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs_on_cpu(capsys):
    out = torch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                            "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 7)
    assert f"[{ARCH}] generated 6 tokens" in capsys.readouterr().out
