"""The port's two remaining attention configs — Qwen2-VL-2B (M-RoPE, a
vision prefix, QKV bias, tied head, momentum) and Whisper-medium (an
encoder tower, cross-attention, GELU, LayerNorm, learned positions,
adamw) — against the reference: the ``RunConfig`` field for field, the
parameter counts at full size, the init at the reduced widths, and a
reduced ADPSGD run of each on the ``vmap`` backends.

Tolerances: the init within three f32 ulps (rtol 5e-7), as the dense and
MoE inits.  The ADPSGD runs (R = 4, batch 2 x 32, 6 steps): the
identical sync schedule, losses and S_k within rtol 1e-4
(``test_torch_engine.py``'s bounds), the final W within 0.05·lr.
Qwen2-VL trains through the training CLI's ``build_engine`` (text only:
``SyntheticTokens`` gives tokens and M-RoPE falls back to t = h = w) against
the reference's CLI setup, momentum at the CLI's lr min(0.1, 0.05).
Whisper's loss needs ``frames``, which neither CLI feeds (the reference's
would raise a ``KeyError``), so both packages train it through
``TrainerEngine`` with a ``data_fn`` that adds seeded frames (R, b, 32,
D) to ``SyntheticTokens``' batches, as the reference's
``tests/test_models.py::make_batch`` builds its batches; adamw at lr
4e-4 on the step schedule.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.backends import VmapBackend as JaxVmapBackend
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch.steps import make_loss_fn as jax_make_loss_fn
from repro.models import model as jax_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import make_lr_schedule as jax_lr
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro.strategies import make_strategy as jax_make_strategy
from repro_torch.backends import VmapBackend
from repro_torch.configs import (AveragingConfig, available_configs,
                                 get_config, reduced)
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import model as torch_model
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.engine import TrainerEngine
from repro_torch.tree import tree_leaves

ARCHS = ["qwen2-vl-2b", "whisper-medium"]
# full size: (params, leaves), the reference's jax.eval_shape over its init
FULL = {"qwen2-vl-2b": (1_543_714_304, 338),
        "whisper-medium": (758_248_448, 725)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_config_matches_reference(arch):
    t, j = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.family == {"qwen2-vl-2b": "vlm",
                              "whisper-medium": "audio"}[arch]
    assert dataclasses.asdict(reduced(t.model, max_seq_len=32)) == \
        dataclasses.asdict(jax_reduced(j.model, max_seq_len=32))
    assert arch in available_configs()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_count(arch):
    """The reference's count by ``jax.eval_shape``; the port's init on the
    meta device (shapes without storage) gives the same count and leaf
    shapes."""
    n_params, n_leaves = FULL[arch]
    cfg = jax_get_config(arch).model
    shapes = jax.eval_shape(
        lambda k: jax_model.init_params(k, cfg), jax.random.PRNGKey(0))
    want = [tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]
    assert sum(int(np.prod(s)) for s in want) == n_params
    assert len(want) == n_leaves
    got = torch_model.init_params(0, get_config(arch).model, device="meta")
    assert [tuple(x.shape) for x in tree_leaves(got)] == want
    assert torch_model.param_count(got) == n_params


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference(arch, seed):
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


# ----------------------------------------------------------- ADPSGD, vmap
STEPS, R, B, SEQ = 6, 4, 2, 32
AVG = dict(method="adpsgd", p_init=2, warmup_full_sync_steps=2,
           k_sample_frac=0.25)
DECAY = (STEPS // 2, 3 * STEPS // 4)


def _check_history(got, ref):
    assert got.sync_steps == ref.sync_steps
    assert got.period_history == ref.period_history
    assert got.n_syncs == ref.n_syncs >= 4
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.s_k, ref.s_k, rtol=1e-4)


def _check_W(got, want, lr):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=0.05 * lr)


def test_qwen2_vl_cli_adpsgd_matches_reference():
    """The port's training CLI setup against the reference CLI's (its
    ``main`` builds the same engine inline)."""
    argv = ["--arch", "qwen2-vl-2b", "--device", "cpu", "--steps",
            str(STEPS), "--replicas", str(R), "--batch", str(B), "--seq",
            str(SEQ), "--warmup-sync", "2", "--p-init", "2"]
    engine, tcfg = train.build_engine(train.parse_args(argv))
    hist = engine.run()

    run = jax_get_config("qwen2-vl-2b")
    jcfg = jax_reduced(run.model, max_seq_len=SEQ)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    lr = min(run.learning_rate, 0.05)
    avg_cfg = JaxAvgCfg(**AVG, p_const=8, inner_period=1)
    data = JaxTokens(jcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    ref = JaxEngine(
        loss_fn=jax_make_loss_fn(jcfg),
        optimizer=jax_get_optimizer(run.optimizer,
                                    momentum_coef=run.momentum),
        params0=jax_model.init_params(jax.random.PRNGKey(0), jcfg),
        n_replicas=R, data_fn=data.batches(n_replicas=R, per_replica_batch=B),
        lr_fn=jax_lr("step", lr, STEPS, decay_steps=DECAY), avg_cfg=avg_cfg,
        total_steps=STEPS, strategy=jax_make_strategy(avg_cfg, STEPS),
        backend=JaxVmapBackend(), track_variance_every=1, seed=0).run()
    assert run.optimizer == "momentum"
    _check_history(hist, ref)
    _check_W(tree_leaves(hist.final_W),
             jax.tree_util.tree_leaves(ref.final_W), lr)


def frames_data_fn(sharder, n_frames, d_model, to_batch):
    """``sharder``'s batches with ``frames`` (R, b, n_frames, d_model)
    added, 0.1·N(0, 1) from ``RandomState(step)``; ``to_batch`` turns the
    numpy arrays into the package's own."""
    def data_fn(step):
        batch = dict(sharder(step))
        frames = 0.1 * np.random.RandomState(step).randn(
            R, B, n_frames, d_model)
        batch["frames"] = to_batch(frames.astype(np.float32))
        return batch
    return data_fn


def test_whisper_adpsgd_with_frames_matches_reference():
    run = get_config("whisper-medium")
    jcfg = jax_reduced(jax_get_config("whisper-medium").model,
                       max_seq_len=SEQ)
    tcfg = reduced(run.model, max_seq_len=SEQ)
    lr = 4e-4
    params0 = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    E, D = jcfg.encoder.n_frames, jcfg.d_model
    jdata = JaxTokens(jcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    tdata = SyntheticTokens(tcfg.vocab_size, SEQ, n_samples=R * B * 64,
                            seed=0)
    ref = JaxEngine(
        loss_fn=jax_make_loss_fn(jcfg),
        optimizer=jax_get_optimizer(run.optimizer), params0=params0,
        n_replicas=R,
        data_fn=frames_data_fn(jdata.batches(n_replicas=R,
                                             per_replica_batch=B),
                               E, D, jax.numpy.asarray),
        lr_fn=jax_lr("step", lr, STEPS, decay_steps=DECAY),
        avg_cfg=JaxAvgCfg(**AVG), total_steps=STEPS,
        backend=JaxVmapBackend()).run()
    port = TrainerEngine(
        loss_fn=make_loss_fn(tcfg), optimizer=get_optimizer(run.optimizer),
        params0=params_from_numpy(params0, "cpu"), n_replicas=R,
        data_fn=frames_data_fn(tdata.batches(n_replicas=R,
                                             per_replica_batch=B,
                                             device="cpu"),
                               E, D, torch.from_numpy),
        lr_fn=make_lr_schedule("step", lr, STEPS, decay_steps=DECAY),
        avg_cfg=AveragingConfig(**AVG), total_steps=STEPS,
        backend=VmapBackend(device="cpu")).run()
    assert run.optimizer == "adamw"
    _check_history(port, ref)
    _check_W(tree_leaves(port.final_W),
             jax.tree_util.tree_leaves(ref.final_W), lr)
