"""The port's flash attention against the reference, on the CPU.

On the CPU the wrapper takes its plain version (``attention_ref``); it is
held against the reference's Pallas kernel in interpret mode and the
reference's ``attention_ref`` on the same numpy inputs, at the shapes and
tolerances of ``tests/test_kernels.py``: 2e-5 in f32 (an online softmax
against an exact one), 2e-2 in bf16 (one bf16 rounding of outputs of
magnitude up to about 1, plus the reference kernel's f32 order).  The
contract is checked too: no gradient, and the same lengths refused.  A
reduced OLMo with ``use_flash`` (S = 128 and 256) gives the reference's
logits to 1e-5 (f32 compute; the attention differs by rounding of the
softmax order only).  The CUDA kernel runs on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as torch_ops
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(B, S, H, K, d, seed, Sk=None):
    rng = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    return (rng.randn(B, S, H, d).astype(np.float32),
            rng.randn(B, Sk, K, d).astype(np.float32),
            rng.randn(B, Sk, K, d).astype(np.float32))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,H,K,d", [
    (1, 128, 4, 4, 64),
    (2, 256, 4, 2, 32),
    (1, 384, 6, 3, 128),
    (2, 128, 8, 1, 64),       # MQA
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
def test_plain_route_matches_pallas_and_oracle(B, S, H, K, d, dtype, window):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, S, H, K, d, seed=S * H + window)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    out = torch_ops.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True,
        window=window)
    assert out.dtype == tdt and out.shape == (B, S, H, d)
    got = out.to(torch.float32).numpy()
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=True, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64), (64, 128)])
def test_block_sizes_match_pallas(block_q, block_k):
    q, k, v = _qkv(1, 256, 4, 2, 64, seed=block_q + 3 * block_k)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, block_q=block_q, block_k=block_k)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=block_q, block_k=block_k,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window,Sk", [(False, 0, 128), (False, 32, 128),
                                              (True, 0, 256), (True, 16, 64)])
def test_non_causal_and_unequal_lengths_match_pallas(causal, window, Sk):
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=7 + Sk + window, Sk=Sk)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("Sq,Sk,block_q,block_k", [
    (100, 100, 128, 128), (200, 200, 128, 128), (256, 384, 128, 128),
    (320, 320, 128, 128), (320, 320, 64, 64), (192, 192, 64, 128),
    (192, 256, 128, 64), (96, 96, 64, 64)])
def test_refuses_the_lengths_the_reference_refuses(Sq, Sk, block_q, block_k):
    q, k, v = _qkv(1, Sq, 2, 1, 32, seed=1, Sk=Sk)
    try:
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=block_q, block_k=block_k, interpret=True)
        ref_refuses = False
    except AssertionError:
        ref_refuses = True
    args = [torch.from_numpy(x) for x in (q, k, v)]
    if ref_refuses:
        with pytest.raises(ValueError, match="multiples"):
            fa.flash_attention(*args, block_q=block_q, block_k=block_k)
    else:
        fa.flash_attention(*args, block_q=block_q, block_k=block_k)


def test_no_gradient_in_the_port_or_the_reference():
    q, k, v = _qkv(1, 128, 2, 1, 32, seed=2)
    with pytest.raises(AssertionError):
        jax.grad(lambda q_: jax_flash(q_, jnp.asarray(k), jnp.asarray(v),
                                      interpret=True).sum())(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention(tq, tk, tv)
    with torch.no_grad():
        fa.flash_attention(tq, tk, tv)


@pytest.mark.parametrize("bad,err", [
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), TypeError),
    (lambda q, k, v: (q.to(torch.float16), k, v), TypeError),
    (lambda q, k, v: (q.transpose(1, 2), k, v), ValueError),
    (lambda q, k, v: (q, k[:, :, :1].expand(-1, -1, 2, -1), v), ValueError),
    (lambda q, k, v: (q[:, :, :3], k, v), ValueError),
    (lambda q, k, v: (q.to("meta"), k.to("meta"), v.to("meta")), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 4, 2, 32, seed=3))
    with pytest.raises(err):
        fa.flash_attention(*bad(q, k, v))


def test_cpu_route_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 2, 2, 32, seed=4))
    before = fa.flash_attention.launches
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before


# ---------------------------------------------------------------- the model
JCFG = jax_reduced(jax_get_config("olmo-1b").model, use_flash=True)
TCFG = reduced(get_config("olmo-1b").model, use_flash=True)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(3), JCFG))


def _counting_flash(monkeypatch):
    calls = []

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return fa.flash_attention(q, k, v, **kw)
    monkeypatch.setattr(torch_layers.kops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("S", [128, 256])
def test_flash_model_forward_and_prefill_match_reference(params, S,
                                                         monkeypatch):
    tokens = np.random.RandomState(S).randint(
        0, JCFG.vocab_size, (2, S)).astype(np.int32)
    logits_j = jax.jit(lambda p, t: jax_model.forward(
        p, {"tokens": t}, JCFG)[0])(params, tokens)
    last_j = jax.jit(jax_prefill_step(JCFG))(params, {"tokens": tokens})
    calls = _counting_flash(monkeypatch)
    tp = params_from_numpy(params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits_t, _ = torch_model.forward(tp, batch, TCFG)
        last_t = make_prefill_step(TCFG)(tp, batch)
    assert calls == [(2, S, TCFG.n_heads, TCFG.head_dim())] * (
        2 * TCFG.n_layers)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        plain, _ = torch_model.forward(
            tp, batch, dataclasses.replace(TCFG, use_flash=False))
    np.testing.assert_allclose(logits_t.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_model_refuses_training(params):
    tp = params_from_numpy(params, "cpu")
    tp["embed"].requires_grad_()
    tokens = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        torch_model.lm_loss(tp, {"tokens": tokens}, TCFG)
