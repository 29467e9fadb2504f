"""The port's two recurrent configs — Jamba-1.5-Large (Mamba + attention
1:7, attention at index 4 of each 8 layers, MoE 16 experts top 2 on every
second layer, plan fsdp) and xLSTM-350M (mLSTM + sLSTM 7:1, the sLSTM at
index 3 of each 8, tied embedding) — against the reference: the
``RunConfig`` field for field, the layer pattern, the full-size counts,
and at the reduced widths (Jamba: mamba then attention with MoE on layer
1; xLSTM: mLSTM then sLSTM) the init, the logits, the loss with its aux
terms and its gradients, decode against the reference's and against
prefill, greedy generation, the serving and training CLIs, an ADPSGD run
of each on the ``vmap`` backends, and xLSTM's checkpoint.

Tolerances: the init within three f32 ulps (rtol 5e-7); logits and loss
rtol 1e-5 (atol 1e-5 on logits); gradients rtol 1e-4 and atol 1e-6 of the
leaf's largest magnitude; decode logits against the reference's rtol =
atol = 1e-5 and against the port's own prefill at the reference's test
bounds (rtol 1e-3, atol 5e-4, ``tests/test_models.py::
test_decode_matches_forward``), Jamba at capacity factor 8.0 as
``test_torch_moe_configs.py`` explains; generated tokens exactly.  The
ADPSGD runs (R = 4, batch 2 x 32, 6 steps, each config's adamw and its
cosine schedule, lr 4e-4): the identical sync schedule, losses, aux
losses and S_k within rtol 1e-4 (``test_torch_engine.py``'s bounds).  The
final W: adamw divides by sqrt(v), so where a gradient is near zero its
f32 rounding becomes a visible share of a step (the trap
``test_torch_engine.py`` states).  Measured on these runs: Jamba's W lies
within 0.044·lr everywhere; in xLSTM's, 16 of 1,986,080 elements lie
beyond 0.05·lr (20 in the run crossed from the port's checkpoint: 1.0e-5
of them), at most 0.22·lr, all in three leaves: layer 0's mLSTM
``conv_w`` (4 elements, up to 0.22·lr) and ``wq`` (4, up to 0.074·lr)
and layer 1's sLSTM gate bias ``b`` (8, or 12 crossed, up to 0.066·lr).
So every leaf of W is held to 0.05·lr, except those three: there, at
most 2e-5 of all of W's elements lie beyond 0.05·lr, and every one
within lr.  This is looser than 0.05·lr everywhere; the xLSTM run with
plain SGD in place of adamw, which has no such amplification, is held to
1e-6 everywhere.  xLSTM's adamw checkpoint after 3 steps resumes bit
for bit in the port and, loaded by the reference, reaches the
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
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro_torch.backends import VmapBackend
from repro_torch.checkpoint import io
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models import model as torch_model
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.engine import TrainerEngine
from repro_torch.tree import tree_leaves

ARCHS = ["jamba-1.5-large-398b", "xlstm-350m"]
MOE_KEYS = ("moe_load_balance", "moe_z_loss")
# full size: (layers (0 = all), param dtype, params, leaves), the
# reference's jax.eval_shape over its init: xLSTM whole, Jamba at 1 and 5
# layers (what fits one card)
FULL = [("xlstm-350m", 0, "float32", 476_656_808, 303),
        ("jamba-1.5-large-398b", 1, "float32", 2_098_077_696, 17),
        ("jamba-1.5-large-398b", 5, "bfloat16", 24_045_707_264, 70)]


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
    if cf is not None and out[0].moe is not None:
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
    assert t.model.family == {"jamba-1.5-large-398b": "hybrid",
                              "xlstm-350m": "ssm"}[arch]
    assert dataclasses.asdict(reduced(t.model, max_seq_len=32)) == \
        dataclasses.asdict(jax_reduced(j.model, max_seq_len=32))


def test_layer_patterns():
    """Jamba: attention at index 4 of each 8 layers (9 of 72), MoE on the
    odd layers; xLSTM: the sLSTM at index 3 of each 8 (3 of 24)."""
    jamba = get_config("jamba-1.5-large-398b").model
    kinds = [jamba.block_kind(i) for i in range(jamba.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == \
        list(range(4, 72, 8))
    assert kinds.count("mamba") == 63
    assert [i for i in range(72) if jamba.layer_uses_moe(i)] == \
        list(range(1, 72, 2))
    xl = get_config("xlstm-350m").model
    kinds = [xl.block_kind(i) for i in range(xl.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [3, 11, 19]
    assert kinds.count("mlstm") == 21
    assert reduced(jamba).layer_pattern == ("mamba", "attn")
    assert reduced(xl).layer_pattern == ("mlstm", "slstm")


@pytest.mark.parametrize("arch,layers,dtype,n_params,n_leaves", FULL)
def test_full_size_param_count(arch, layers, dtype, n_params, n_leaves):
    """The reference's count, shapes and dtypes by ``jax.eval_shape``; the
    port's init on the meta device (shapes without storage) gives the
    same.  In bf16, Jamba's A_log and D stay f32 on both sides."""
    kw = dict(param_dtype=dtype, **({"n_layers": layers} if layers else {}))
    cfg = dataclasses.replace(jax_get_config(arch).model, **kw)
    shapes = jax.eval_shape(
        lambda k: jax_model.init_params(k, cfg), jax.random.PRNGKey(0))
    want = [(tuple(x.shape), str(x.dtype))
            for x in jax.tree_util.tree_leaves(shapes)]
    assert sum(int(np.prod(s)) for s, _ in want) == n_params
    assert len(want) == n_leaves
    got = torch_model.init_params(
        0, dataclasses.replace(get_config(arch).model, **kw), device="meta")
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree_leaves(got)] \
        == want
    assert torch_model.param_count(got) == n_params


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
    assert set(aux_ft) == set(aux_fj)
    assert set(aux_t) == set(aux_j)
    assert set(aux_j) == set(MOE_KEYS + ("ce_loss",) if jcfg.moe
                             else ("ce_loss",))
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


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
def test_decode_matches_reference_and_prefill(arch):
    """Every decode step against the reference's, and against the port's
    own full-sequence forward at that position; the caches are a KV cache
    for the attention layer and a recurrent state for the others."""
    jcfg, tcfg = _cfgs(arch, cf=8.0)
    params, prompt = _params(jcfg, seed=3), _tokens(jcfg, 2, 12, seed=4)
    tp = params_from_numpy(params, "cpu")
    with torch.no_grad():
        full, _ = torch_model.forward(tp, {"tokens": torch.from_numpy(prompt)},
                                      tcfg)
    jc = jax_model.init_caches(jcfg, 2, 12, dtype=jnp.float32)
    tc = torch_model.init_caches(tcfg, 2, 12, dtype=torch.float32,
                                 device="cpu")
    assert [sorted(c) for c in tc["layers"]] == \
        [sorted(c) for c in jc["layers"]]
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
    for got, want in zip(tc["layers"], jc["layers"]):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("layers,S", [(4, 512), (8, 1024)])
def test_xlstm_bf16_distance_from_f32_is_the_references(layers, S):
    """xLSTM-350M at full width, 4 layers (3 mLSTM and the sLSTM at index
    3) over 1 x 512 tokens (two 256-token mLSTM chunks), and 8 layers (one
    whole pattern) over 1 x 1024, seed 0: bf16 compute lies far from f32
    in the reference as in the port, and further with depth and length
    (the readings are printed with ``-s``), so that gap is the model's at
    random init.  The port's f32 logits within the reference's test
    bounds of the reference's (rtol 1e-3, atol 5e-4: jit's fusions
    against eager, amplified over depth and length); its bf16 distance
    from f32 within a factor 1.5 of the reference's, at the last token
    and over all tokens."""
    kw = dict(n_layers=layers, max_seq_len=S)
    jcfg = dataclasses.replace(jax_get_config("xlstm-350m").model, **kw)
    tcfg = dataclasses.replace(get_config("xlstm-350m").model, **kw)
    params, tokens = _params(jcfg), _tokens(jcfg, 1, S, seed=5)
    tp = params_from_numpy(params, "cpu")
    out = {}
    for cd in ("float32", "bfloat16"):
        j = dataclasses.replace(jcfg, compute_dtype=cd)
        out["ref", cd] = np.asarray(jax.jit(lambda p, t: jax_model.forward(
            p, {"tokens": t}, j)[0])(params, tokens), np.float32)[0]
        with torch.no_grad():
            out["port", cd] = torch_model.forward(
                tp, {"tokens": torch.from_numpy(tokens)},
                dataclasses.replace(tcfg, compute_dtype=cd))[0][0].float() \
                .numpy()
    np.testing.assert_allclose(out["port", "float32"], out["ref", "float32"],
                               rtol=1e-3, atol=5e-4)
    for where, sl in (("last token", -1), ("all tokens", slice(None))):
        gap = {side: float(np.abs(out[side, "bfloat16"][sl]
                                  - out[side, "float32"][sl]).max())
               for side in ("ref", "port")}
        print(f"xlstm-350m, {layers} layers, S {S}, {where}: bf16 from "
              f"f32 {gap}; "
              f"largest |f32 logit| "
              f"{float(np.abs(out['ref', 'float32'][sl]).max())}")
        assert gap["ref"] / 1.5 <= gap["port"] <= 1.5 * gap["ref"], where


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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_each_config_on_cpu(arch):
    hist = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                       "--replicas", "2", "--batch", "1", "--seq", "16",
                       "--warmup-sync", "1"])
    assert len(hist.losses) == 2 and all(np.isfinite(hist.losses))
    assert hist.n_syncs >= 1


# ----------------------------------------------------------- ADPSGD, vmap
STEPS, HALF, R, B, SEQ, LR = 6, 3, 4, 2, 32, 4e-4
AVG = dict(method="adpsgd", p_init=2, warmup_full_sync_steps=2,
           k_sample_frac=0.25)


def _runs(arch, root, checkpoint, opt=None):
    """The reference's uninterrupted run and the port's, with the config's
    schedule and optimizer (or ``opt``); with ``checkpoint``, also the
    port's first 3
    steps saved, a fresh port engine resumed from that checkpoint, and
    the reference resumed from it."""
    jcfg, tcfg = _cfgs(arch)
    run = get_config(arch)
    opt = opt or run.optimizer
    params0 = _params(jcfg)
    jdata = JaxTokens(jcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    tdata = SyntheticTokens(tcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)

    def jax_engine():
        return JaxEngine(
            loss_fn=jax_make_loss_fn(jcfg),
            optimizer=jax_get_optimizer(opt), params0=params0,
            n_replicas=R,
            data_fn=jdata.batches(n_replicas=R, per_replica_batch=B),
            lr_fn=jax_lr(run.lr_schedule, LR, STEPS),
            avg_cfg=JaxAvgCfg(**AVG), total_steps=STEPS,
            backend=JaxVmapBackend(use_kernel=True))

    def torch_engine():
        return TrainerEngine(
            loss_fn=make_loss_fn(tcfg), optimizer=get_optimizer(opt),
            params0=params_from_numpy(params0, "cpu"), n_replicas=R,
            data_fn=tdata.batches(n_replicas=R, per_replica_batch=B,
                                  device="cpu"),
            lr_fn=make_lr_schedule(run.lr_schedule, LR, STEPS),
            avg_cfg=AveragingConfig(**AVG), total_steps=STEPS,
            backend=VmapBackend(use_kernel=True, device="cpu"))

    h_ref = jax_engine().run()
    port = torch_engine()
    h_port = port.run()
    out = dict(ref=h_ref, port=h_port, port_W=tree_leaves(port.W))
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
def xlstm_runs(tmp_path_factory):
    return _runs("xlstm-350m", tmp_path_factory.mktemp("xlstm"),
                 checkpoint=True)


def _check_history(got, ref):
    assert got.sync_steps == ref.sync_steps
    assert got.period_history == ref.period_history
    assert got.n_syncs == ref.n_syncs >= 4
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    np.testing.assert_allclose(got.s_k, ref.s_k, rtol=1e-4)


# xLSTM's leaves where adamw's amplification of f32 rounding shows
XLSTM_LOOSE = ("['blocks'][0]['mlstm']['conv_w']",
               "['blocks'][0]['mlstm']['wq']", "['blocks'][1]['slstm']['b']")


def _check_adamw_W(got, want, n_leaves, loose=()):
    """Every leaf within 0.05·lr, except the ``loose`` ones (by path):
    there at most 2e-5 of all the elements lie beyond 0.05·lr, and every
    one within lr."""
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got) == len(want) == n_leaves
    beyond = total = 0
    for g, (path, w) in zip(got, want):
        name = jax.tree_util.keystr(path)
        d = np.abs(np.asarray(g) - np.asarray(w))
        total += d.size
        if name in loose:
            beyond += int((d > 0.05 * LR).sum())
            assert d.max() <= LR, name
        else:
            assert d.max() <= 0.05 * LR, name
    assert beyond <= 2e-5 * total


def test_xlstm_adpsgd_matches_reference(xlstm_runs):
    _check_history(xlstm_runs["port"], xlstm_runs["ref"])
    _check_adamw_W([x.numpy() for x in xlstm_runs["port_W"]],
                   xlstm_runs["ref"].final_W, 25, XLSTM_LOOSE)


def test_xlstm_adpsgd_with_sgd_matches_reference(tmp_path):
    runs = _runs("xlstm-350m", tmp_path, checkpoint=False, opt="sgd")
    _check_history(runs["port"], runs["ref"])
    want = jax.tree_util.tree_leaves(runs["ref"].final_W)
    assert len(runs["port_W"]) == len(want) == 25
    for g, w in zip(runs["port_W"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_jamba_adpsgd_matches_reference(tmp_path):
    runs = _runs("jamba-1.5-large-398b", tmp_path, checkpoint=False)
    _check_history(runs["port"], runs["ref"])
    _check_adamw_W([x.numpy() for x in runs["port_W"]],
                   runs["ref"].final_W, 27)


def test_xlstm_checkpoint_resumes_bit_for_bit(xlstm_runs):
    port, tail = xlstm_runs["port"], xlstm_runs["tail"]
    n = len([s for s in port.sync_steps if s >= HALF])
    assert n >= 1
    assert tail.sync_steps == port.sync_steps[-n:]
    assert tail.period_history == port.period_history[-n:]
    assert tail.losses == port.losses[HALF:]
    assert tail.s_k == port.s_k[-n:]
    assert all(torch.equal(a, b) for a, b in zip(xlstm_runs["tail_W"],
                                                 xlstm_runs["port_W"]))


def test_xlstm_checkpoint_crosses_to_reference(xlstm_runs):
    ref, cross = xlstm_runs["ref"], xlstm_runs["cross"]
    n = len([s for s in ref.sync_steps if s >= HALF])
    assert cross.sync_steps == ref.sync_steps[-n:]
    assert cross.n_syncs == n
    np.testing.assert_allclose(cross.losses, ref.losses[HALF:], rtol=1e-4)
    np.testing.assert_allclose(cross.s_k, ref.s_k[-n:], rtol=1e-4)
    _check_adamw_W(xlstm_runs["cross_W"], ref.final_W, 25, XLSTM_LOOSE)
