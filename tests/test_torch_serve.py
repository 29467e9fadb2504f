"""The port's serving path against the reference, on the CPU: KV caches,
``decode_step``, ``make_serve_step`` and ``generate`` on a reduced OLMo
with the same parameters (via ``interop``) and prompts.

Tolerances: decode logits rtol/atol 1e-5 (f32 compute on both sides; the
port's matmuls and softmax round in another order), generated tokens
exactly.  Prefill and decode of the port agree at the last prompt token to
1e-5 (the same function computed over the whole prompt or token by token
against the cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as torch_serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model

JCFG = jax_reduced(jax_get_config("olmo-1b").model)
TCFG = reduced(get_config("olmo-1b").model)
CONFIGS = {"dense": ({}, {}),
           "flash": ({"use_flash": True}, {"use_flash": True}),
           "window": ({"sliding_window": 6, "use_flash": True},
                      {"sliding_window": 6, "use_flash": True})}


def _cfgs(name):
    j, t = CONFIGS[name]
    return dataclasses.replace(JCFG, **j), dataclasses.replace(TCFG, **t)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(5), JCFG))


def _prompt(B, S, seed):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("window,max_len", [(0, 24), (6, 24), (32, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_match_reference(window, max_len, dtype):
    jc = jax_model.init_caches(dataclasses.replace(JCFG, sliding_window=window),
                               3, max_len, dtype=jnp.dtype(dtype))
    tc = torch_model.init_caches(
        dataclasses.replace(TCFG, sliding_window=window), 3, max_len,
        dtype=getattr(torch, dtype), device="cpu")
    assert len(tc["layers"]) == len(jc["layers"]) == TCFG.n_layers
    assert tc["index"].dtype == torch.int32 and int(tc["index"]) == 0
    for t, j in zip(tc["layers"], jc["layers"]):
        assert sorted(t) == sorted(j)
        for key in t:
            assert tuple(t[key].shape) == j[key].shape
            assert str(t[key].dtype).split(".")[-1] == str(j[key].dtype)
            np.testing.assert_array_equal(
                t[key].to(torch.float32).numpy(),
                np.asarray(j[key], np.float32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_logits_match_reference_step_by_step(params, name):
    jcfg, tcfg = _cfgs(name)
    prompt = _prompt(2, 10, seed=11)
    jc = jax_model.init_caches(jcfg, 2, 10, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, 2, 10, dtype=torch.float32,
                                 device="cpu")
    tp = params_from_numpy(params, "cpu")
    jstep = jax.jit(lambda p, b, c: jax_model.decode_step(p, b, c, jcfg))
    for t in range(prompt.shape[1]):
        tok = prompt[:, t:t + 1]
        lj, jc = jstep(params, {"tokens": tok}, jc)
        with torch.no_grad():
            lt, tc = torch_model.decode_step(
                tp, {"tokens": torch.from_numpy(tok)}, tc, tcfg)
        assert lt.shape == lj.shape == (2, 1, tcfg.padded_vocab())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
        assert int(tc["index"]) == int(jc["index"]) == t + 1
    for t, j in zip(tc["layers"], jc["layers"]):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        np.testing.assert_allclose(t["k"].numpy(), np.asarray(j["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_tokens_identical_to_reference(params, name, monkeypatch):
    jcfg, tcfg = _cfgs(name)
    prompt = _prompt(2, 8, seed=12)
    want = np.asarray(jax_serve.generate(jcfg, params, jnp.asarray(prompt), 8))
    calls = []
    monkeypatch.setattr(torch_layers.kops, "flash_attention",
                        lambda *a, **k: calls.append(1))
    got = torch_serve.generate(tcfg, params_from_numpy(params, "cpu"),
                               torch.from_numpy(prompt), 8)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == []                     # decode never reaches the kernel


def test_serve_step_matches_reference(params):
    prompt = _prompt(3, 1, seed=13)
    jc = jax_model.init_caches(JCFG, 3, 4, dtype=jnp.float32)
    nxt_j, _ = jax.jit(jax_serve_step(JCFG))(params, {"tokens": prompt}, jc)
    tc = torch_model.init_caches(TCFG, 3, 4, dtype=torch.float32,
                                 device="cpu")
    with torch.no_grad():
        nxt_t, tc = make_serve_step(TCFG)(
            params_from_numpy(params, "cpu"),
            {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    assert int(tc["index"]) == 1


@pytest.mark.parametrize("name", ["dense", "flash"])
def test_prefill_and_decode_agree_at_last_prompt_token(params, name):
    _, tcfg = _cfgs(name)
    prompt = torch.from_numpy(_prompt(2, 128, seed=14))
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        last = make_prefill_step(tcfg)(tp, {"tokens": prompt})
        caches = torch_model.init_caches(tcfg, 2, 128, dtype=torch.float32,
                                         device="cpu")
        for t in range(128):
            logits, caches = torch_model.decode_step(
                tp, {"tokens": prompt[:, t:t + 1]}, caches, tcfg)
    np.testing.assert_allclose(logits[:, 0].numpy(), last.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sliding_window_stays_off_the_flash_branch(params, monkeypatch):
    _, tcfg = _cfgs("window")
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return fa.flash_attention(*a, **k)
    monkeypatch.setattr(torch_layers.kops, "flash_attention", counted)
    tp = params_from_numpy(params, "cpu")
    tokens = torch.from_numpy(_prompt(2, 128, seed=15))
    with torch.no_grad():
        make_prefill_step(tcfg)(tp, {"tokens": tokens})
        assert calls == []
        make_prefill_step(dataclasses.replace(tcfg, sliding_window=0))(
            tp, {"tokens": tokens})
    assert len(calls) == tcfg.n_layers


def test_decode_refuses_more_than_one_token(params):
    tc = torch_model.init_caches(TCFG, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        torch_model.decode_step(params_from_numpy(params, "cpu"),
                                {"tokens": torch.zeros(1, 2, dtype=torch.int32)},
                                tc, TCFG)


def test_serve_cli_runs_on_cpu(capsys):
    out = torch_serve.main(["--device", "cpu", "--batch", "2",
                            "--prompt-len", "6", "--gen", "5"])
    assert out.shape == (2, 11)
    assert "generated 10 tokens" in capsys.readouterr().out


def test_caches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_model.init_caches(TCFG, 1, 4)
