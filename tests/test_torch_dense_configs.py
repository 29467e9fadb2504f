"""The three dense configs of the port — MiniCPM-2B, GLM4-9B and
Qwen2.5-14B — against the reference: the ``RunConfig`` field for field,
the registry, and at the reduced widths (parameters carried across with
``interop``) the logits, the LM loss and its gradients, the prefill step,
decode step by step and greedy generation.

Each config exercises knobs OLMo-1B leaves at their defaults: MiniCPM's
embedding, residual and logit scales and its tied head over RMSNorm;
GLM4's QKV bias, half rotary dims and two KV heads; Qwen2.5's QKV bias,
rope theta 1e6, eight KV heads and untied head.  Tolerances are those of
``test_torch_model.py`` (logits and loss rtol 1e-5, gradients rtol 1e-4
atol 1e-6) and ``test_torch_serve.py`` (decode logits rtol = atol = 1e-5,
generated tokens exactly).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import available_configs as jax_available_configs
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import model as jax_model
from repro_torch.configs import (ParallelismPlan, available_configs,
                                 get_config, reduced)
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import model as torch_model
from repro_torch.tree import tree_leaves

ARCHS = ["minicpm-2b", "glm4-9b", "qwen2.5-14b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jax_reduced(jax_get_config(arch).model, max_seq_len=32),
            reduced(get_config(arch).model, max_seq_len=32))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed), jcfg))


def _tokens(jcfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_config_matches_reference(arch):
    t, j = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.parallelism == ParallelismPlan(plan="replica_dp")
    assert t.replace(learning_rate=0.5).learning_rate == 0.5
    assert dataclasses.asdict(reduced(t.model, max_seq_len=32)) == \
        dataclasses.asdict(jax_reduced(j.model, max_seq_len=32))


@pytest.mark.parametrize("change", [
    {"plan": "model_parallel"}, {"placement": "replica_nope"}])
def test_parallelism_plan_refuses_what_no_backend_reads(change):
    """A plan that is none of the reference's (``replica_dp``, ``fsdp``
    and ``replica_ddp`` are data the vmap backend ignores, as the
    reference's does: ``test_torch_moe_configs.py``) is refused, and so
    is a placement the mesh backend does not have."""
    with pytest.raises((NotImplementedError, ValueError),
                       match="mesh backend"):
        ParallelismPlan(**change)
    assert ParallelismPlan() == ParallelismPlan(plan="replica_dp")


@pytest.mark.parametrize("change", [
    {"placement": "replica_tp"}, {"shard_activations": False},
    {"remat_policy": "dots"}, {"vocab_parallel_embed": False}])
def test_parallelism_plan_carries_the_replica_tp_fields(change):
    """The fields of the ``replica_tp`` placement are the reference's
    data: ``placement`` picks the mesh backend's layout and
    ``vocab_parallel_embed`` the embedding's rule
    (``launch/sharding.py``); ``shard_activations`` and ``remat_policy``
    are read by no module of either package."""
    plan = ParallelismPlan(**change)
    (k, v), = change.items()
    assert getattr(plan, k) == v
    assert ParallelismPlan(**change) == plan


def test_available_configs_lists_the_ported_configs():
    """Every config of the reference is ported."""
    got = available_configs()
    assert set(ARCHS + ["olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b",
                        "qwen2-vl-2b", "whisper-medium", "xlstm-350m",
                        "jamba-1.5-large-398b"]) == set(got)
    assert list(got) == list(jax_available_configs())


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match(arch):
    jcfg, tcfg = _cfgs(arch)
    params, tokens = _params(jcfg), _tokens(jcfg, 2, 16, seed=1)
    logits_j = jax.jit(lambda p, t: jax_model.forward(
        p, {"tokens": t}, jcfg)[0])(params, tokens)
    loss_j, _ = jax.jit(lambda p, t: jax_model.lm_loss(
        p, {"tokens": t}, jcfg))(params, tokens)
    tp = params_from_numpy(params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits_t, _ = torch_model.forward(tp, batch, tcfg)
        loss_t, _ = torch_model.lm_loss(tp, batch, tcfg)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match(arch):
    jcfg, tcfg = _cfgs(arch)
    params, tokens = _params(jcfg), _tokens(jcfg, 2, 16, seed=2)
    grads_j = jax.jit(jax.grad(lambda p, t: jax_model.lm_loss(
        p, {"tokens": t}, jcfg)[0]))(params, tokens)
    tp = params_from_numpy(params, "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(tp)]
    loss, _ = torch_model.lm_loss(tp, {"tokens": torch.from_numpy(tokens)},
                                  tcfg)
    grads_t = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(grads_t) == len(want)
    for g_t, g_j in zip(grads_t, want):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """The prefill step's last logits, then the prompt fed token by token
    through ``decode_step``: each step's logits and the caches."""
    jcfg, tcfg = _cfgs(arch)
    params, prompt = _params(jcfg, seed=3), _tokens(jcfg, 2, 10, seed=4)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        last = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(
        last.numpy(), np.asarray(jax_prefill_step(jcfg)(
            params, {"tokens": prompt})), rtol=1e-5, atol=1e-5)
    jc = jax_model.init_caches(jcfg, 2, 10, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, 2, 10, dtype=torch.float32,
                                 device="cpu")
    jstep = jax.jit(lambda p, b, c: jax_model.decode_step(p, b, c, jcfg))
    for t in range(prompt.shape[1]):
        tok = prompt[:, t:t + 1]
        lj, jc = jstep(params, {"tokens": tok}, jc)
        with torch.no_grad():
            lt, tc = torch_model.decode_step(
                tp, {"tokens": torch.from_numpy(tok)}, tc, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    np.testing.assert_allclose(lt[:, 0].numpy(), last.numpy(), rtol=1e-5,
                               atol=1e-5)
    for t, j in zip(tc["layers"], jc["layers"]):
        np.testing.assert_allclose(t["k"].numpy(), np.asarray(j["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_to_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    params, prompt = _params(jcfg, seed=5), _tokens(jcfg, 2, 6, seed=6)
    want = np.asarray(jax_serve.generate(jcfg, params, jnp.asarray(prompt), 6))
    got = torch_serve.generate(tcfg, params_from_numpy(params, "cpu"),
                               torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_config_on_cpu(arch, capsys):
    out = torch_serve.main(["--arch", arch, "--device", "cpu", "--batch", "1",
                            "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (1, 7)
    assert f"[{arch}] generated 3 tokens" in capsys.readouterr().out
