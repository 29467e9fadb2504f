"""Configs, period controllers, LR schedules and wire accounting: the port
against the reference, exactly (all pure python on both sides)."""
import dataclasses

import numpy as np
import pytest

from repro.backends import ops as jax_ops
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import controller as jax_ctrl
from repro.optim import make_lr_schedule as jax_lr
from repro.strategies import available_strategies as jax_available_strategies
from repro.strategies import comm_stats_for as jax_comm_stats_for
from repro_torch.backends import ops as torch_ops
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.core import controller as torch_ctrl
from repro_torch.core.comm_model import GBPS_10
from repro_torch.optim import make_lr_schedule
from repro_torch.strategies import available_strategies, comm_stats_for

CONTROLLERS = ["ADPSGDController", "ConstantPeriodController",
               "DecreasingPeriodController", "FullSyncController",
               "HierarchicalADPSGDController"]
AVG_CASES = [
    dict(p_init=2, warmup_full_sync_steps=2, k_sample_frac=0.25),
    dict(p_init=4, p_const=3, warmup_full_sync_steps=0, k_sample_frac=0.0),
    dict(p_init=1, warmup_full_sync_steps=5, k_sample_frac=0.5,
         lower=0.9, upper=1.1, p_max=6, decreasing_p0=7, decreasing_p1=2),
]


def _run(ctrl, s_ks, lrs):
    decisions = []
    for k, (s_k, lr) in enumerate(zip(s_ks, lrs)):
        sync = ctrl.sync_now(k)
        decisions.append((sync, ctrl.period))
        if sync:
            ctrl.observe(k, lr, s_k)
    return decisions, ctrl.sync_steps, ctrl.period_history, ctrl.state_dict()


@pytest.mark.parametrize("name", CONTROLLERS)
@pytest.mark.parametrize("case", range(len(AVG_CASES)))
def test_controllers_make_identical_decisions(name, case):
    steps = 120
    rng = np.random.RandomState(case)
    # a drifting, noisy probe so the adaptive rule moves both ways
    s_ks = list(np.exp(rng.randn(steps)) * np.linspace(1.0, 3.0, steps))
    lr_j = jax_lr("step", 0.05, steps, decay_steps=(60, 90))
    lr_t = make_lr_schedule("step", 0.05, steps, decay_steps=(60, 90))
    lrs = [lr_t(k) for k in range(steps)]
    assert lrs == [lr_j(k) for k in range(steps)]
    kw = AVG_CASES[case]
    got = _run(getattr(torch_ctrl, name)(AveragingConfig(**kw), steps),
               s_ks, lrs)
    want = _run(getattr(jax_ctrl, name)(JaxAvgCfg(**kw), steps), s_ks, lrs)
    assert got == want
    if name == "ADPSGDController" and case == 0:
        assert len(set(got[2])) > 1       # the period actually adapted


@pytest.mark.parametrize("kind", ["constant", "step", "cosine", "wsd"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedules_agree(kind, warmup):
    kw = dict(warmup_steps=warmup, decay_steps=(30, 45))
    t = make_lr_schedule(kind, 4e-4, 60, **kw)
    j = jax_lr(kind, 4e-4, 60, **kw)
    assert [t(k) for k in range(70)] == [j(k) for k in range(70)]


@pytest.mark.parametrize("op", ["all_mean_op", "full_step_op",
                                "replica_step_op", "opt_mean_op"])
def test_wire_bytes_identical(op):
    t, j = getattr(torch_ops, op)(), getattr(jax_ops, op)()
    assert (t.name, t.collective, t.is_step) == (j.name, j.collective, j.is_step)
    for n_params in (1, 532_202, 371_458_048):
        for n_nodes in (1, 2, 4, 8, 16):
            assert t.wire_bytes(n_params, n_nodes) == \
                j.wire_bytes(n_params, n_nodes)


@pytest.mark.parametrize("op", ["qsgd_step_op", "quantized_all_mean_op"])
@pytest.mark.parametrize("bits", [4, 8])
def test_qsgd_wire_bytes_identical(op, bits):
    t, j = getattr(torch_ops, op)(bits), getattr(jax_ops, op)(bits)
    assert (t.name, t.collective, t.is_step) == (j.name, j.collective, j.is_step)
    assert t.collective == "gather_bcast"
    assert (t.wire.kind, t.wire.bits, t.wire.norm_bytes_per_tensor) == \
        (j.wire.kind, j.wire.bits, j.wire.norm_bytes_per_tensor)
    for n_params in (1, 532_202, 371_458_048):
        for n_nodes in (1, 2, 4, 8, 16):
            for n_tensors in (0, 15, 29):
                assert t.wire_bytes(n_params, n_nodes, n_tensors) == \
                    j.wire_bytes(n_params, n_nodes, n_tensors)


@pytest.mark.parametrize("method", ["adpsgd", "cpsgd", "decreasing", "fullsgd",
                                    "qsgd", "qsgd_periodic", "hier_adpsgd",
                                    "adacomm", "dasgd"])
def test_comm_stats_identical(method):
    assert method in available_strategies()
    assert available_strategies() == jax_available_strategies()
    args = (532_202, 8, 60, 12, GBPS_10)
    got = comm_stats_for(method, AveragingConfig(method=method), *args)
    want = jax_comm_stats_for(method, JaxAvgCfg(method=method), *args)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_configs_match_reference():
    t, j = get_config("olmo-1b"), jax_get_config("olmo-1b")
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    for f in ("optimizer", "learning_rate", "momentum", "weight_decay",
              "lr_schedule"):
        assert getattr(t, f) == getattr(j, f)
    assert dataclasses.asdict(reduced(t.model, max_seq_len=32)) == \
        dataclasses.asdict(jax_reduced(j.model, max_seq_len=32))
    assert dataclasses.asdict(AveragingConfig()) == \
        dataclasses.asdict(JaxAvgCfg())


@pytest.mark.parametrize("case", range(len(AVG_CASES)))
@pytest.mark.parametrize("inner_period", [1, 2, 3])
def test_hierarchical_controller_identical(case, inner_period):
    """Outer ADPSGD decisions, inner constant-period decisions, and the
    outer sync resetting the inner count, as the strategy drives them."""
    steps = 120
    rng = np.random.RandomState(10 + case)
    s_ks = np.exp(rng.randn(steps)) * np.linspace(1.0, 3.0, steps)
    lr = make_lr_schedule("step", 0.05, steps, decay_steps=(60, 90))
    out = []
    for mod, cfg_cls in ((torch_ctrl, AveragingConfig), (jax_ctrl, JaxAvgCfg)):
        ctrl = mod.HierarchicalADPSGDController(
            cfg_cls(**AVG_CASES[case], inner_period=inner_period), steps)
        trace = []
        for k in range(steps):
            if ctrl.sync_now(k):
                ctrl.reset_inner()
                ctrl.observe(k, lr(k), float(s_ks[k]))
                trace.append(("outer", ctrl.period))
            elif ctrl.inner_sync_now(k):
                trace.append(("inner", ctrl.period))
        out.append((trace, ctrl.sync_steps, ctrl.inner_sync_steps,
                    ctrl.state_dict(), ctrl.n_syncs, ctrl.mean_period()))
    assert out[0] == out[1]
    if inner_period == 2 and case == 0:
        assert out[0][2]                       # inner syncs happened


@pytest.mark.parametrize("interval", [4, 20])
@pytest.mark.parametrize("p_init", [2, 8])
def test_adacomm_controller_identical(interval, p_init):
    """AdaComm's iteration blocks: tau = ceil(tau0·sqrt(F/F0)) from a
    noisy decaying loss, in the reference's f64 arithmetic."""
    steps = 200
    rng = np.random.RandomState(interval + p_init)
    losses = 2.3 * np.exp(-np.arange(steps) / 70) + 0.05 * rng.rand(steps)
    out = []
    for mod, cfg_cls in ((torch_ctrl, AveragingConfig), (jax_ctrl, JaxAvgCfg)):
        ctrl = mod.AdaCommController(cfg_cls(
            method="adacomm", p_init=p_init, adacomm_interval=interval,
            warmup_full_sync_steps=2), steps)
        for k in range(steps):
            ctrl.sync_now(k)
            ctrl.observe_loss(k, float(losses[k]))
        out.append((ctrl.sync_steps, ctrl.period_history, ctrl.state_dict()))
    assert out[0] == out[1]
    assert len(set(out[0][1])) > 1


@pytest.mark.parametrize("method", ["adpsgd", "cpsgd", "decreasing", "fullsgd",
                                    "qsgd", "qsgd_periodic", "hier_adpsgd",
                                    "adacomm", "dasgd"])
def test_make_controller_identical(method):
    got = torch_ctrl.make_controller(AveragingConfig(method=method), 10)
    want = jax_ctrl.make_controller(JaxAvgCfg(method=method), 10)
    assert type(got).__name__ == type(want).__name__


@pytest.mark.parametrize("op,args", [("inner_mean_op", (2,)),
                                     ("inner_mean_op", (4,)),
                                     ("mean_delta_op", ()),
                                     ("apply_delta_op", ())])
def test_hierarchical_and_dasgd_ops_identical(op, args):
    kw = [{"overlap": True}, {}] if op == "mean_delta_op" else [{}]
    for k in kw:
        t, j = getattr(torch_ops, op)(*args, **k), \
            getattr(jax_ops, op)(*args, **k)
        assert (t.name, t.collective, t.is_step, t.group, t.overlap) == \
            (j.name, j.collective, j.is_step, j.group, j.overlap)
        for n_params in (1, 532_202, 371_458_048):
            for n_nodes in (1, 2, 4, 8):
                assert t.wire_bytes(n_params, n_nodes, 29) == \
                    j.wire_bytes(n_params, n_nodes, 29)
