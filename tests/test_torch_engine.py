"""The slice as a whole: ADPSGD on reduced OLMo, R = 4, 16 steps, adamw,
with the sync kernel on — the reference's vmap engine (Pallas kernel in
interpret mode) against the port's engine (the kernel wrapper's CPU route)
from the same parameters and data.  The schedule must be identical; losses
and S_k agree to rtol 1e-4 (f32 sums taken in another order, carried
through 16 steps).  The final W agrees to atol 2e-5, which is 0.05·lr:
adamw divides by sqrt(v), so where a gradient is near zero its rounding
error becomes a visible share of a step of size lr (measured on this
setup: 4 of 131,072 elements of one leaf differ by 1.14e-5, the rest by
less than 1e-5).

The QSGD strategies run the same way (``qsgd_periodic`` and ``qsgd``, 16
steps each), through the same threefry keys.  Schedule, losses and S_k
are held as for ADPSGD.  Their final W spreads further, because a
quantized exchange turns the two libraries' last-bit differences into
whole levels: where a uniform lies within a rounding of its fraction a
level flips by one quantum norm/s, and where the replicas' levels cancel
the mean gradient is a difference of norms near adamw's eps.  adamw then
moves such an element by up to about lr per step in one run and not the
other.  Measured on this setup: beyond 0.05·lr lie 432 of 1,572,864
elements for ``qsgd_periodic`` (max 1.86e-4 = 0.47·lr) and 4,072 for
``qsgd`` (max 6.04e-4 = 1.51·lr); with plain SGD in place of adamw the
same ``qsgd`` runs agree to 2.1e-6 everywhere.  The test holds all but
0.5 % of the elements to 0.05·lr and every element to 2·lr."""
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
from repro_torch.backends import VmapBackend
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import qsgd_quant
from repro_torch.kernels.param_variance import mean_and_sqdev
from repro_torch.launch import train
from repro_torch.launch.steps import make_loss_fn
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime.engine import TrainerEngine
from repro_torch.tree import tree_leaves

STEPS, R, B, SEQ = 16, 4, 4, 32
LR = 4e-4
AVG = dict(method="adpsgd", p_init=2, warmup_full_sync_steps=2,
           k_sample_frac=0.25)
DECAY = (STEPS // 2, 3 * STEPS // 4)


def _both_engines(avg):
    """The reference's vmap engine and the port's, from the same params
    and data, run to the end: (jax history, port history)."""
    jcfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=SEQ)
    params0 = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jdata = JaxTokens(jcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    jeng = JaxEngine(
        loss_fn=jax_make_loss_fn(jcfg), optimizer=jax_get_optimizer("adamw"),
        params0=params0, n_replicas=R,
        data_fn=jdata.batches(n_replicas=R, per_replica_batch=B),
        lr_fn=jax_lr("step", LR, STEPS, decay_steps=DECAY),
        avg_cfg=JaxAvgCfg(**avg), total_steps=STEPS,
        backend=JaxVmapBackend(use_kernel=True))
    jhist = jeng.run()

    tcfg = reduced(get_config("olmo-1b").model, max_seq_len=SEQ)
    tdata = SyntheticTokens(tcfg.vocab_size, SEQ, n_samples=R * B * 64, seed=0)
    teng = TrainerEngine(
        loss_fn=make_loss_fn(tcfg), optimizer=get_optimizer("adamw"),
        params0=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params0), "cpu"),
        n_replicas=R,
        data_fn=tdata.batches(n_replicas=R, per_replica_batch=B,
                              device="cpu"),
        lr_fn=make_lr_schedule("step", LR, STEPS, decay_steps=DECAY),
        avg_cfg=AveragingConfig(**avg), total_steps=STEPS,
        backend=VmapBackend(use_kernel=True, device="cpu"))
    launches = _launches()
    thist = teng.run()
    assert _launches() == launches                # CPU route: no launches
    return jhist, thist


def _launches():
    return (mean_and_sqdev.launches, qsgd_quant.sqnorm.launches,
            qsgd_quant.quantize.launches, qsgd_quant.dequantize.launches)


@pytest.fixture(scope="module")
def runs():
    return _both_engines(AVG)


@pytest.fixture(scope="module", params=["qsgd_periodic", "qsgd"])
def qsgd_runs(request):
    return request.param, _both_engines(dict(AVG, method=request.param))


def test_sync_schedule_identical(runs):
    jhist, thist = runs
    assert thist.sync_steps == jhist.sync_steps
    assert thist.period_history == jhist.period_history
    assert thist.n_syncs == jhist.n_syncs >= 4
    assert len(set(thist.period_history)) > 1      # warm-up, then adaptation


def test_losses_and_probe_close(runs):
    jhist, thist = runs
    assert len(thist.losses) == STEPS
    np.testing.assert_allclose(thist.losses, jhist.losses, rtol=1e-4)
    np.testing.assert_allclose(thist.s_k, jhist.s_k, rtol=1e-4)
    np.testing.assert_allclose(thist.lrs, jhist.lrs, rtol=0)


def test_final_weights_close(runs):
    jhist, thist = runs
    got = tree_leaves(thist.final_W)
    want = jax.tree_util.tree_leaves(jhist.final_W)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=0.05 * LR, rtol=0)


def test_qsgd_sync_schedule_identical(qsgd_runs):
    method, (jhist, thist) = qsgd_runs
    assert thist.sync_steps == jhist.sync_steps
    assert thist.period_history == jhist.period_history
    if method == "qsgd":
        assert thist.n_syncs == jhist.n_syncs == STEPS
        assert not thist.sync_steps          # no separate sync program
    else:
        assert thist.n_syncs == jhist.n_syncs >= 4
        assert len(set(thist.period_history)) > 1


def test_qsgd_losses_and_probe_close(qsgd_runs):
    _, (jhist, thist) = qsgd_runs
    assert len(thist.losses) == STEPS
    np.testing.assert_allclose(thist.losses, jhist.losses, rtol=1e-4)
    np.testing.assert_allclose(thist.s_k, jhist.s_k, rtol=1e-4)


def test_qsgd_final_weights_close(qsgd_runs):
    method, (jhist, thist) = qsgd_runs
    got = tree_leaves(thist.final_W)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jhist.final_W)]
    assert len(got) == len(want) == 15
    diffs = np.concatenate([np.abs(g.numpy() - w).ravel()
                            for g, w in zip(got, want)])
    assert np.mean(diffs > 0.05 * LR) <= 0.005
    assert diffs.max() <= 2 * LR
    if method == "qsgd":                     # replicas stay identical
        assert all(torch.equal(g[r], g[0]) for g in got for r in range(R))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = reduced(get_config("olmo-1b").model, max_seq_len=SEQ)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerEngine(loss_fn=make_loss_fn(cfg),
                      optimizer=get_optimizer("adamw"), n_replicas=R,
                      data_fn=None, lr_fn=lambda k: 1e-3, total_steps=2,
                      avg_cfg=AveragingConfig(**AVG))


def test_training_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "hist.json"
    hist = train.main(["--device", "cpu", "--steps", "6", "--seq", "16",
                       "--replicas", "2", "--batch", "2", "--warmup-sync",
                       "1", "--method", "cpsgd", "--p-const", "2",
                       "--eval-every", "3", "--out", str(out)])
    assert hist.sync_steps == [0, 2, 4] and hist.eval_steps == [2, 5]
    assert all(np.isfinite(e["ce_loss"]) for e in hist.evals)
    assert np.all(np.isfinite(hist.losses)) and out.exists()


@pytest.mark.parametrize("method", ["qsgd_periodic", "qsgd"])
def test_training_cli_runs_qsgd_on_cpu(method, capsys):
    hist = train.main(["--device", "cpu", "--steps", "5", "--seq", "16",
                       "--replicas", "2", "--batch", "2", "--warmup-sync",
                       "1", "--method", method])
    out = capsys.readouterr().out
    assert np.all(np.isfinite(hist.losses)) and len(hist.losses) == 5
    assert f"syncs={hist.n_syncs}" in out and "wire: " in out
    assert "qsgd_int8, 8 bits" in out
    if method == "qsgd":
        assert hist.n_syncs == 5
    else:
        assert hist.n_syncs >= 2 and np.all(np.isfinite(hist.s_k))
