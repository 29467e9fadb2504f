"""The port's two MoE configs — Mixtral-8x22B (8 experts top 2, sliding
window 4096, plan fsdp) and DeepSeek-V2-Lite (MLA, 64 routed experts top 6
with 2 shared, a dense first layer) — against the reference: the
``RunConfig`` field for field, and at the reduced widths the init, the
logits, the loss with its aux terms and its gradients, decode against
prefill, greedy generation, and an ADPSGD run of reduced DeepSeek on the
``vmap`` backends with its checkpoint.

Tolerances: the init within three f32 ulps (rtol 5e-7); logits and loss
rtol 1e-5, gradients rtol 1e-4 and atol 1e-6 of the leaf's largest
magnitude (sums over the routed tokens in another order,
``test_torch_moe.py``); decode logits against the reference's rtol = atol
= 1e-5 and against the port's own prefill at the reference's test bounds
(rtol 1e-3, atol 5e-4, ``tests/test_models.py::test_decode_matches_forward``);
generated tokens exactly.  Decode and prefill are compared at capacity
factor 8.0, as the reference's own test does: the prefill routes a whole
group of tokens and may drop some at capacity, decode routes one token at
a time and never drops, so at the config's 1.25 the two may differ by
design.  The ADPSGD run (R = 4, batch 2 x 32, 6 steps, adamw, lr 4e-4):
the identical sync schedule, losses, aux losses and S_k within rtol 1e-4
(``test_torch_engine.py``'s bounds).  The final W: adamw divides by
sqrt(v), so where a gradient is near zero its f32 rounding becomes a
visible share of a step (the trap ``test_torch_engine.py`` states).
Measured on this run: 8 of 1,758,208 elements lie beyond 0.05·lr (in
layer 0's MLA ``wq`` and layer 1's experts' ``w_up``; at most 1.38e-4 =
0.34·lr), so
W is held to 0.05·lr on all but 1e-5 of its elements and to lr on every
one; the same run with plain SGD in place of adamw agrees to 1.2e-7 and
is held to 1e-6 everywhere.  The adamw run's checkpoint after 3 steps
resumes bit for bit in the port and, loaded by the reference, reaches the
reference's uninterrupted run within the same bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import VmapBackend as JaxVmapBackend
from repro.checkpoint import io as jax_io
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch import serve as jax_serve
from repro.launch.steps import make_loss_fn as jax_make_loss_fn
from repro.models import model as jax_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import make_lr_schedule as jax_lr
from repro.runtime.engine import Callback as JaxCallback
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro_torch.backends import VmapBackend
from repro_torch.checkpoint import io
from repro_torch.configs import (AveragingConfig, ParallelismPlan,
                                 get_config, reduced)
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import model as torch_model
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.engine import Callback, TrainerEngine
from repro_torch.tree import tree_leaves

ARCHS = ["mixtral-8x22b", "deepseek-v2-lite-16b"]
MOE_KEYS = ("moe_load_balance", "moe_z_loss")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, cf=None):
    out = [jax_reduced(jax_get_config(arch).model, max_seq_len=32),
           reduced(get_config(arch).model, max_seq_len=32)]
    if cf is not None:
        out = [dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in out]
    return out


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
    assert t.model.family == "moe"
    assert dataclasses.asdict(reduced(t.model, max_seq_len=32)) == \
        dataclasses.asdict(jax_reduced(j.model, max_seq_len=32))


def test_plans_are_data():
    """Mixtral's fsdp plan builds; the vmap backend, which reads no plan
    (as the reference's), trains a config whatever its plan says."""
    assert get_config("mixtral-8x22b").parallelism == \
        ParallelismPlan(plan="fsdp")
    for plan in ("replica_dp", "fsdp", "replica_ddp"):
        assert ParallelismPlan(plan=plan).plan == plan
    hist = train.main(["--arch", "mixtral-8x22b", "--device", "cpu",
                       "--steps", "2", "--replicas", "2", "--batch", "1",
                       "--seq", "16", "--warmup-sync", "1"])
    assert len(hist.losses) == 2 and all(np.isfinite(hist.losses))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    want = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    got = torch_model.init_params(seed, tcfg, device="cpu")
    assert jax.tree_util.tree_structure(params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_aux_match(arch):
    jcfg, tcfg = _cfgs(arch)
    params, tokens = _params(jcfg), _tokens(jcfg, 2, 32, seed=1)
    logits_j, aux_fj = jax.jit(lambda p, t: jax_model.forward(
        p, {"tokens": t}, jcfg))(params, tokens)
    loss_j, aux_j = jax.jit(lambda p, t: jax_model.lm_loss(
        p, {"tokens": t}, jcfg))(params, tokens)
    tp = params_from_numpy(params, "cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits_t, aux_ft = torch_model.forward(tp, batch, tcfg)
        loss_t, aux_t = torch_model.lm_loss(tp, batch, tcfg)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    assert set(aux_ft) == set(aux_fj) == set(MOE_KEYS)
    assert set(aux_t) == set(aux_j) == set(MOE_KEYS + ("ce_loss",))
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert float(loss_t) > float(aux_t["ce_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match(arch):
    jcfg, tcfg = _cfgs(arch)
    params, tokens = _params(jcfg), _tokens(jcfg, 2, 32, seed=2)
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
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(g_j).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_at_capacity_8(arch):
    """At capacity factor 8.0: every decode step against the reference's,
    and against the port's own full-sequence forward at that position."""
    jcfg, tcfg = _cfgs(arch, cf=8.0)
    params, prompt = _params(jcfg, seed=3), _tokens(jcfg, 2, 12, seed=4)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        full, _ = torch_model.forward(tp, {"tokens": torch.from_numpy(prompt)},
                                      tcfg)
    jc = jax_model.init_caches(jcfg, 2, 12, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, 2, 12, dtype=torch.float32,
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
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-3, atol=5e-4, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_to_reference(arch):
    jcfg, tcfg = _cfgs(arch, cf=8.0)
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


# ----------------------------------------------------------- ADPSGD, vmap
STEPS, HALF, R, B, SEQ, LR = 6, 3, 4, 2, 32, 4e-4
AVG = dict(method="adpsgd", p_init=2, warmup_full_sync_steps=2,
           k_sample_frac=0.25)
DECAY = (STEPS // 2, 3 * STEPS // 4)


class _JaxAux(JaxCallback):
    def __init__(self, save_at=None, path=None):
        self.aux, self.save_at, self.path = [], save_at, path

    def on_step_end(self, engine, k, metrics):
        self.aux.append([float(metrics[n]) for n in MOE_KEYS])

    def on_iteration_end(self, engine, k, metrics):
        if self.save_at is not None and k + 1 == self.save_at:
            jax_io.save_checkpoint(
                self.path, engine.W, opt_state=engine.opt_state, step=k + 1,
                controller_state=jax_io.strategy_state(engine.strategy))


class _Aux(Callback):
    def __init__(self):
        self.aux = []

    def on_step_end(self, engine, k, metrics):
        self.aux.append([float(metrics[n]) for n in MOE_KEYS])


def _deepseek_runs(root, opt, checkpoint):
    """The reference's uninterrupted run and the port's, with optimizer
    ``opt``; with ``checkpoint``, also the port's first 3 steps saved, a
    fresh port engine resumed from that checkpoint, and the reference
    resumed from it."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    jcfg = dataclasses.replace(jcfg, max_seq_len=SEQ)
    tcfg = dataclasses.replace(tcfg, max_seq_len=SEQ)
    params0 = _params(jcfg)
    jdata = JaxTokens(jcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    tdata = SyntheticTokens(tcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)

    def jax_engine(callbacks=()):
        return JaxEngine(
            loss_fn=jax_make_loss_fn(jcfg),
            optimizer=jax_get_optimizer(opt), params0=params0,
            n_replicas=R,
            data_fn=jdata.batches(n_replicas=R, per_replica_batch=B),
            lr_fn=jax_lr("step", LR, STEPS, decay_steps=DECAY),
            avg_cfg=JaxAvgCfg(**AVG), total_steps=STEPS,
            backend=JaxVmapBackend(use_kernel=True),
            callbacks=list(callbacks))

    def torch_engine(callbacks=()):
        return TrainerEngine(
            loss_fn=make_loss_fn(tcfg), optimizer=get_optimizer(opt),
            params0=params_from_numpy(params0, "cpu"), n_replicas=R,
            data_fn=tdata.batches(n_replicas=R, per_replica_batch=B,
                                  device="cpu"),
            lr_fn=make_lr_schedule("step", LR, STEPS, decay_steps=DECAY),
            avg_cfg=AveragingConfig(**AVG), total_steps=STEPS,
            backend=VmapBackend(use_kernel=True, device="cpu"),
            callbacks=list(callbacks))

    jaux = _JaxAux()
    h_ref = jax_engine([jaux]).run()
    taux = _Aux()
    port = torch_engine([taux])
    h_port = port.run()
    out = dict(ref=h_ref, port=h_port, ref_aux=jaux.aux, port_aux=taux.aux,
               port_W=tree_leaves(port.W))
    if not checkpoint:
        return out

    path = str(root / "port")
    first = torch_engine()
    first.run(num_steps=HALF)
    io.save_checkpoint(path, first.W, opt_state=first.opt_state, step=HALF,
                       controller_state=io.strategy_state(first.strategy))
    resumed = torch_engine()
    W, opt_state, meta = io.load_checkpoint(path, device="cpu")
    resumed.load_state(W, opt_state, strategy_state=meta["controller"])
    h_tail = resumed.run(start_step=HALF)

    jres = jax_engine()
    W, opt_state, meta = jax_io.load_checkpoint(path)

    def graft(like, tree):
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like), jax.tree_util.tree_leaves(tree))

    jres.load_state(graft(jres.W, W), graft(jres.opt_state, opt_state),
                    strategy_state=meta["controller"])
    h_cross = jres.run(start_step=HALF)
    return dict(out, tail=h_tail, tail_W=tree_leaves(resumed.W),
                cross=h_cross, cross_W=jax.tree_util.tree_leaves(jres.W))


@pytest.fixture(scope="module")
def deepseek_runs(tmp_path_factory):
    return _deepseek_runs(tmp_path_factory.mktemp("deepseek"), "adamw",
                          checkpoint=True)


def _check_history(got, ref, got_aux=None, ref_aux=None):
    assert got.sync_steps == ref.sync_steps
    assert got.period_history == ref.period_history
    assert got.n_syncs == ref.n_syncs >= 4
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.s_k, ref.s_k, rtol=1e-4)
    if got_aux is not None:
        np.testing.assert_allclose(got_aux, ref_aux, rtol=1e-4)


def _check_adamw_W(got, want):
    """0.05·lr on all but 1e-5 of the elements, lr on every one."""
    assert len(got) == len(want) == 27
    diffs = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel()
                            for g, w in zip(got, want)])
    assert np.mean(diffs > 0.05 * LR) <= 1e-5
    assert diffs.max() <= LR


def test_deepseek_adpsgd_matches_reference(deepseek_runs):
    _check_history(deepseek_runs["port"], deepseek_runs["ref"],
                   deepseek_runs["port_aux"], deepseek_runs["ref_aux"])
    _check_adamw_W([x.numpy() for x in deepseek_runs["port_W"]],
                   jax.tree_util.tree_leaves(deepseek_runs["ref"].final_W))


def test_deepseek_adpsgd_with_sgd_matches_reference(tmp_path):
    runs = _deepseek_runs(tmp_path, "sgd", checkpoint=False)
    _check_history(runs["port"], runs["ref"], runs["port_aux"],
                   runs["ref_aux"])
    want = jax.tree_util.tree_leaves(runs["ref"].final_W)
    assert len(runs["port_W"]) == len(want) == 27
    for g, w in zip(runs["port_W"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_deepseek_checkpoint_resumes_bit_for_bit(deepseek_runs):
    port, tail = deepseek_runs["port"], deepseek_runs["tail"]
    n = len([s for s in port.sync_steps if s >= HALF])
    assert n >= 1
    assert tail.sync_steps == port.sync_steps[-n:]
    assert tail.period_history == port.period_history[-n:]
    assert tail.losses == port.losses[HALF:]
    assert tail.s_k == port.s_k[-n:]
    assert all(torch.equal(a, b) for a, b in zip(deepseek_runs["tail_W"],
                                                 deepseek_runs["port_W"]))


def test_deepseek_checkpoint_crosses_to_reference(deepseek_runs):
    ref, cross = deepseek_runs["ref"], deepseek_runs["cross"]
    n = len([s for s in ref.sync_steps if s >= HALF])
    assert cross.sync_steps == ref.sync_steps[-n:]
    assert cross.n_syncs == n
    np.testing.assert_allclose(cross.losses, ref.losses[HALF:], rtol=1e-4)
    np.testing.assert_allclose(cross.s_k, ref.s_k[-n:], rtol=1e-4)
    _check_adamw_W(deepseek_runs["cross_W"],
                   jax.tree_util.tree_leaves(ref.final_W))
