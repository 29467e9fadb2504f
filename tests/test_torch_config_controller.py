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
from repro.strategies import comm_stats_for as jax_comm_stats_for
from repro_torch.backends import ops as torch_ops
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.core import controller as torch_ctrl
from repro_torch.core.comm_model import GBPS_10
from repro_torch.optim import make_lr_schedule
from repro_torch.strategies import available_strategies, comm_stats_for

CONTROLLERS = ["ADPSGDController", "ConstantPeriodController",
               "DecreasingPeriodController", "FullSyncController"]
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


@pytest.mark.parametrize("method", ["adpsgd", "cpsgd", "decreasing", "fullsgd"])
def test_comm_stats_identical(method):
    assert method in available_strategies()
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
