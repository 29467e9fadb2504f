"""The telemetry clock (``runtime/clock.py``) and the new comm-model
functions: the port against the reference.

* Pricing (``resolve_net``, ``comm_time`` per collective, ``method_comm``,
  ``speedup_vs_fullsgd``, ``SimulatedClock.comm_cost``) is pure python on
  both sides and must agree exactly.
* The ``SimulatedClock`` Timeline of a whole run — every record's name,
  step, compute_s, comm_s, bytes, t_start, t_end and overlap flag — equals
  the reference's float for float, for all nine strategies, on the CNN
  (R = 4, widths (8, 16), 12 steps, 10 Gbps; DaSGD also on a link too slow
  for its overlap window to hide the exchange).  The schedules these
  records follow come from losses and S_k that agree to about 1e-7 here
  (the CNN keeps the reference's parameter layout, so even QSGD's levels
  are the reference's).
* The ``WallClock`` on the CPU: one record per program, waiting on no
  CUDA device; with ``sample_every=4`` waits only on sampled steps, flags
  the rest as interpolated, and each closed window's records sum to the
  real time it spans; ``load_state_dict`` re-bases ``now()``.
* A clock leaves training bit-identical.
* ``AdaCommTimeController``'s periods against the reference's under 10 vs
  1000 Gbps, and its straggler rescaling.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.backends import VmapBackend as JaxVmapBackend
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.core import comm_model as jax_cm
from repro.core.controller import AdaCommTimeController as JaxAdaCommTime
from repro.data.pipeline import SyntheticImages as JaxImages
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import make_lr_schedule as jax_lr
from repro.runtime import clock as jax_clock
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro.strategies import available_strategies as jax_strategies
from repro_torch.backends import VmapBackend
from repro_torch.configs import AveragingConfig
from repro_torch.core import comm_model as cm
from repro_torch.core.controller import AdaCommTimeController
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.interop import params_from_numpy
from repro_torch.models.cnn import cnn_loss
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime import clock as clk
from repro_torch.runtime.engine import Callback, TrainerEngine
from repro_torch.tree import tree_leaves

STEPS, R, B = 12, 4, 4
AVG = dict(p_init=2, p_const=4, k_sample_frac=0.25, warmup_full_sync_steps=2,
           inner_period=2, adacomm_interval=4)
STRATEGIES = sorted(jax_strategies())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread.  The convolutions here are tiny
    and gain nothing from more; under the test runner's parallel workers
    the thread pools of several processes spin against each other and
    slow these tests many times over; and one thread makes the float sums
    independent of the host's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cnn_setup():
    params0 = jax.tree_util.tree_map(
        np.asarray, jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16)))
    return params0, JaxImages(n_samples=128, seed=0), \
        SyntheticImages(n_samples=128, seed=0)


def jax_engine(cnn_setup, method, clock, **kw):
    params0, data, _ = cnn_setup
    return JaxEngine(
        loss_fn=jax_cnn_loss, optimizer=jax_get_optimizer("momentum"),
        params0=jax.tree_util.tree_map(jax.numpy.asarray, params0),
        n_replicas=R, data_fn=data.batches(n_replicas=R, per_replica_batch=B),
        lr_fn=jax_lr("step", 0.05, STEPS, decay_steps=(8,)),
        avg_cfg=JaxAvgCfg(method=method, **dict(AVG, **kw)),
        total_steps=STEPS, clock=clock,
        backend=JaxVmapBackend(use_kernel=True))


def torch_engine(cnn_setup, method, clock, callbacks=(), **kw):
    params0, _, data = cnn_setup
    return TrainerEngine(
        loss_fn=cnn_loss, optimizer=get_optimizer("momentum"),
        params0=params_from_numpy(params0, "cpu"), n_replicas=R,
        data_fn=data.batches(n_replicas=R, per_replica_batch=B,
                             device="cpu"),
        lr_fn=make_lr_schedule("step", 0.05, STEPS, decay_steps=(8,)),
        avg_cfg=AveragingConfig(method=method, **dict(AVG, **kw)),
        total_steps=STEPS, clock=clock, callbacks=callbacks,
        backend=VmapBackend(use_kernel=True, device="cpu"))


def _records(timeline):
    return [(r.name, r.step, r.compute_s, r.comm_s, r.bytes, r.t_start,
             r.t_end, r.overlap) for r in timeline.records]


# --------------------------------------------------------------- pricing
@pytest.mark.parametrize("spec", ["10gbps", "100gbps", "25gbps", "0.01gbps",
                                  "1000GBPS"])
def test_resolve_net(spec):
    assert dataclasses.asdict(clk.resolve_net(spec)) == \
        dataclasses.asdict(jax_clock.resolve_net(spec))
    net = clk.NetworkModel("x", 1e9, intra_bandwidth=4e9)
    assert clk.resolve_net(net) is net and net.intra == 4e9
    with pytest.raises(ValueError, match="unknown network"):
        clk.resolve_net("fast")


@pytest.mark.parametrize("collective", ["all_reduce", "all_gather",
                                        "gather_bcast", "inner_mean"])
def test_comm_time_per_collective(collective):
    for n_nodes in (1, 2, 4, 8, 16):
        for nbytes in (0.0, 931353.5, 3725414.0, 2.2e9):
            for bw in (cm.GBPS_10, cm.GBPS_100):
                got = cm.comm_time(nbytes, 3, n_nodes, bw,
                                   collective=collective)
                assert got == jax_cm.comm_time(nbytes, 3, n_nodes, bw,
                                               collective=collective)
            for net in ("10gbps", "100gbps"):
                assert clk.SimulatedClock(net).comm_cost(
                    nbytes, collective, n_nodes) == \
                    jax_clock.SimulatedClock(net).comm_cost(
                        nbytes, collective, n_nodes)
    with pytest.raises(ValueError, match="unknown collective"):
        cm.comm_time(1.0, 1, 4, cm.GBPS_10, collective="ring")


@pytest.mark.parametrize("method", ["fullsgd", "cpsgd", "adpsgd",
                                    "decreasing", "qsgd"])
def test_method_comm_and_speedup_identical(method):
    for bw in (cm.GBPS_10, cm.GBPS_100):
        args = (532_202, 8, 60, 11)
        assert dataclasses.astuple(cm.method_comm(method, *args, bw)) == \
            dataclasses.astuple(jax_cm.method_comm(method, *args, bw))
        assert cm.speedup_vs_fullsgd(method, *args, 5e-3, bw) == \
            jax_cm.speedup_vs_fullsgd(method, *args, 5e-3, bw)
    with pytest.raises(ValueError):
        cm.method_comm("dasgd", 10, 2, 1, 1, cm.GBPS_10)


def test_make_clock():
    assert clk.make_clock(None) is None and clk.make_clock("none") is None
    wall = clk.make_clock("real", wallclock_sample_every=8)
    assert isinstance(wall, clk.WallClock) and wall.sample_every == 8
    assert wall.defer_loss_readback
    assert not clk.make_clock("wall").defer_loss_readback
    sim = clk.make_clock("10gbps", wallclock_sample_every=8)
    assert isinstance(sim, clk.SimulatedClock) and sim.kind == "sim"
    assert sim.state_dict() == {"kind": "sim", "t": 0.0, "net": "10gbps"}
    assert clk.make_clock(sim) is sim
    with pytest.raises(ValueError, match="straggler"):
        clk.SimulatedClock("100gbps", straggler=0.5)


# ------------------------------------------------------- simulated clock
def _margin_spy(ctrl, margins):
    """Record how far each adaptive decision of a run lies from flipping:
    ADPSGD's S_k / (lr·C2) from its thresholds 0.7 and 1.3 (relative),
    AdaComm's tau0·sqrt(F/F0) from the nearest integer its ceil jumps
    at."""
    if hasattr(ctrl, "c2"):
        observe = ctrl.observe

        def spy(k, lr, s_k):
            c2, n = ctrl.c2, ctrl.n_c2
            observe(k, lr, s_k)
            if k >= ctrl.cfg.warmup_full_sync_steps and \
                    k >= ctrl.k_sample and n:
                r = s_k / (lr * c2)
                margins.append(min(abs(r - ctrl.cfg.lower) / ctrl.cfg.lower,
                                   abs(r - ctrl.cfg.upper) / ctrl.cfg.upper))
        ctrl.observe = spy
    elif hasattr(ctrl, "tau0"):
        observe_loss = ctrl.observe_loss

        def spy_loss(k, loss):
            n, total, f0 = ctrl._loss_n, ctrl._loss_sum, ctrl.f0
            observe_loss(k, loss)
            if ctrl._loss_n == 0 and f0 is not None:
                x = ctrl.tau0 * math.sqrt((total + loss) / (n + 1) / f0)
                margins.append(abs(x - round(x)))
        ctrl.observe_loss = spy_loss


@pytest.mark.parametrize("method", STRATEGIES)
def test_simulated_timeline_matches_reference(cnn_setup, method):
    """Record for record.  The adaptive schedules rest on the reference's
    decisions lying at least 1e-2 from flipping (measured: 0.022 for
    ADPSGD's thresholds, 0.11 for AdaComm's ceil), far beyond the port's
    S_k and loss differences (about 1e-7; up to a few 1e-3 for
    ``qsgd_periodic``, where a rounding difference can flip a level)."""
    jclock, tclock = (jax_clock.SimulatedClock("10gbps"),
                      clk.SimulatedClock("10gbps"))
    jeng = jax_engine(cnn_setup, method, jclock)
    margins = []
    _margin_spy(getattr(jeng.strategy, "controller", None), margins)
    jhist = jeng.run()
    thist = torch_engine(cnn_setup, method, tclock).run()
    assert all(m >= 1e-2 for m in margins)
    assert thist.sync_steps == jhist.sync_steps
    assert thist.inner_sync_steps == jhist.inner_sync_steps
    assert thist.period_history == jhist.period_history
    assert thist.n_syncs == jhist.n_syncs
    assert _records(tclock.timeline) == _records(jclock.timeline)
    assert thist.timing == jhist.timing
    assert thist.timing["n_records"] >= STEPS


def test_dasgd_remainder_timeline_matches_reference(cnn_setup):
    """On a link too slow for two local steps to hide the exchange, the
    fetch stalls for the remainder, identically."""
    kw = dict(step_compute_s=1e-4)
    jclock = jax_clock.SimulatedClock("0.01gbps", **kw)
    tclock = clk.SimulatedClock("0.01gbps", **kw)
    jax_engine(cnn_setup, "dasgd", jclock).run()
    torch_engine(cnn_setup, "dasgd", tclock).run()
    assert _records(tclock.timeline) == _records(jclock.timeline)
    fetches = [r for r in tclock.timeline.records
               if r.name == "mean_delta.fetch"]
    assert fetches and all(f.t_end > f.t_start and f.comm_s == 0.0
                           for f in fetches)


class _Spy(Callback):
    def __init__(self):
        self.step_timings, self.sync_timings = [], []

    def on_step_end(self, engine, k, metrics):
        self.step_timings.append(metrics.get("timing"))

    def on_sync(self, engine, k, s_k, timing=None):
        self.sync_timings.append((k, timing))


@pytest.mark.parametrize("method", ["adpsgd", "dasgd"])
def test_callbacks_receive_timing(cnn_setup, method):
    spy = _Spy()
    hist = torch_engine(cnn_setup, method, clk.SimulatedClock("10gbps"),
                        callbacks=[spy]).run()
    assert all(t is not None and t.name == "replica_step"
               for t in spy.step_timings)
    assert [k for k, _ in spy.sync_timings] == hist.sync_steps
    for k, t in spy.sync_timings:
        assert t.step == k and t.comm_s > 0
        # DaSGD's probe arrives with the exchange's record, not the apply's
        assert t.name in ("all_mean", "mean_delta")
    spy = _Spy()
    torch_engine(cnn_setup, method, None, callbacks=[spy]).run()
    assert all(t is None for t in spy.step_timings)
    assert all(t is None for _, t in spy.sync_timings)


# ------------------------------------------------------------ wall clock
@pytest.fixture
def no_cuda_sync(monkeypatch):
    """The clock must never synchronize a CUDA device for CPU tensors."""
    def refuse(*a, **k):
        raise AssertionError("torch.cuda.synchronize called for a CPU run")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_wallclock_one_record_per_dispatch(cnn_setup, no_cuda_sync):
    clock = clk.WallClock()
    hist = torch_engine(cnn_setup, "dasgd", clock).run()
    recs = clock.timeline.records
    by = hist.timing["by_program"]
    assert hist.timing["clock"] == "wall"
    assert by["replica_step"]["calls"] == STEPS
    assert by["all_mean"]["calls"] == 2              # the two warm-up syncs
    assert by["mean_delta"]["calls"] == by["mean_delta.fetch"]["calls"] == 2
    assert by["apply_delta"]["calls"] == 2
    # every non-overlap program and every fetch waited once
    assert clock.n_blocks == len(recs) - by["mean_delta"]["calls"]
    assert not any(r.interpolated for r in recs)
    assert all(r.t_end >= r.t_start for r in recs)
    assert hist.timing["compute_s"] > 0 and hist.timing["comm_s"] > 0
    assert hist.timing["total_s"] <= hist.wall_s


def test_wallclock_sampled_windows(cnn_setup, no_cuda_sync):
    """``sample_every=4``: waits only on steps 0, 4, 8; records between
    are interpolated; each closed window's records (plus the sampled
    program's own) sum to the real time since the previous sample."""
    clock = clk.WallClock(sample_every=4)
    windows = []
    measure = clock.measure

    def checked(name, fn, args, **kw):
        window, mark = list(clock._window), clock._mark
        out = measure(name, fn, args, **kw)
        if window and not clock.timeline.last.interpolated:
            own = clock.timeline.last
            got = sum(r.compute_s + r.comm_s for r, _ in window) \
                + own.compute_s + own.comm_s
            windows.append((got, clock._mark - mark))
        return out

    clock.measure = checked
    hist = torch_engine(cnn_setup, "cpsgd", clock).run()
    recs = clock.timeline.records
    sampled = [r for r in recs if r.step % 4 == 0]
    assert clock.n_blocks == len(sampled) < len(recs)
    assert all(r.interpolated == bool(r.step % 4) for r in recs)
    assert len(windows) == 2                     # closed at steps 4 and 8
    for got, elapsed in windows:
        assert got == pytest.approx(elapsed, rel=1e-9)
    assert all(isinstance(x, float) for x in hist.losses)
    unclocked = torch_engine(cnn_setup, "cpsgd", None).run()
    assert hist.losses == unclocked.losses
    tl = clock.timeline
    assert tl.compute_s + tl.comm_s == pytest.approx(
        sum(r.compute_s + r.comm_s for r in recs))


def test_wallclock_load_state_dict_rebases():
    clock = clk.WallClock()
    clock.load_state_dict({"t": 123.0})
    assert 123.0 <= clock.now() < 124.0
    assert clock.state_dict()["kind"] == "wall"
    sim = clk.SimulatedClock("10gbps")
    sim.load_state_dict({"t": 7.5})
    assert sim.now() == 7.5


@pytest.mark.parametrize("net", ["10gbps", "real", "real4"])
@pytest.mark.parametrize("method", ["adpsgd", "dasgd", "hier_adpsgd"])
def test_clock_leaves_training_bit_identical(cnn_setup, method, net):
    clock = (clk.WallClock(sample_every=4) if net == "real4"
             else clk.make_clock(net))
    plain = torch_engine(cnn_setup, method, None).run()
    clocked = torch_engine(cnn_setup, method, clock).run()
    assert clocked.losses == plain.losses and clocked.s_k == plain.s_k
    assert clocked.sync_steps == plain.sync_steps
    assert plain.timing is None and clocked.timing is not None
    for a, b in zip(tree_leaves(clocked.final_W), tree_leaves(plain.final_W)):
        assert torch.equal(a, b)


# ------------------------------------------------- AdaComm's time mode
def _drive_time_controller(cls, clock_mod, net, *, steps=400, straggler=1.0,
                           nbytes=36e6, t0=0.03, tau0=16):
    """The periodic dispatch loop against a SimulatedClock: one step
    charge per iteration, one all-reduce per scheduled sync, a loss that
    decays in the iteration index — the period trajectory is a pure
    function of the simulated network."""
    clock = clock_mod.SimulatedClock(net, step_compute_s=1e-3,
                                     straggler=straggler)
    cfg_cls = AveragingConfig if clock_mod is clk else JaxAvgCfg
    ctrl = cls(cfg_cls(method="adacomm", p_init=tau0, adacomm_mode="time",
                       adacomm_t0=t0), steps)
    ctrl.bind_clock(clock)
    trace = []
    for k in range(steps):
        clock.measure("replica_step", lambda: None, (), is_step=True)
        if ctrl.sync_now(k):
            clock.measure("all_mean", lambda: None, (), is_step=False,
                          comm_bytes=nbytes, collective="all_reduce",
                          n_nodes=4)
        ctrl.observe_loss(k, math.exp(-k / 40))
        trace.append((clock.now(), ctrl.period))
    return trace, ctrl


@pytest.mark.parametrize("straggler", [1.0, 2.5])
def test_adacomm_time_periods_match_reference(straggler):
    """10 vs 1000 Gbps: the port's period trajectory equals the
    reference's at every iteration, and the slow link holds the larger
    periods (the paper's trend)."""
    traces = {}
    for net in ("10gbps", "1000gbps"):
        got, ctrl = _drive_time_controller(AdaCommTimeController, clk, net,
                                           straggler=straggler)
        want, jctrl = _drive_time_controller(JaxAdaCommTime, jax_clock, net,
                                             straggler=straggler)
        assert got == want
        assert ctrl.sync_steps == jctrl.sync_steps
        assert ctrl.state_dict() == jctrl.state_dict()
        traces[net] = got
    slow, fast = traces["10gbps"], traces["1000gbps"]
    assert [p for _, p in slow] != [p for _, p in fast]
    # at the same simulated time the slow link holds the larger period
    end = min(slow[-1][0], fast[-1][0])
    grid = [end * i / 20 for i in range(1, 21)]
    p_slow = [_period_at(slow, t) for t in grid]
    p_fast = [_period_at(fast, t) for t in grid]
    assert all(a >= b for a, b in zip(p_slow, p_fast))
    assert any(a > b for a, b in zip(p_slow, p_fast))


def _period_at(trace, t):
    p = trace[0][1]
    for tt, pp in trace:
        if tt > t:
            break
        p = pp
    return p


@pytest.mark.parametrize("s,expect", [(1.0, 8), (4.0, 4), (16.0, 2),
                                      (2.0, 6)])
def test_adacomm_time_straggler_rescaling(s, expect):
    """tau = ceil(tau0 · sqrt(F/F0) / sqrt(s)), with F == F0 isolating the
    straggler term: ceil(8 / sqrt(s)), as in the reference."""
    periods = []
    for cls, mod, cfg_cls in ((AdaCommTimeController, clk, AveragingConfig),
                              (JaxAdaCommTime, jax_clock, JaxAvgCfg)):
        clock = mod.SimulatedClock("100gbps", step_compute_s=1e-3,
                                   straggler=s)
        ctrl = cls(cfg_cls(method="adacomm", p_init=8, adacomm_mode="time",
                           adacomm_t0=0.01), 100)
        ctrl.bind_clock(clock)
        ctrl.f0, ctrl._block_start = 1.0, 0.0
        for _ in range(30):
            clock.measure("replica_step", lambda: None, (), is_step=True)
        ctrl.observe_loss(0, 1.0)
        periods.append(ctrl.period)
    assert periods == [expect, expect]


def test_adacomm_time_needs_clock():
    ctrl = AdaCommTimeController(
        AveragingConfig(method="adacomm", adacomm_mode="time"), 10)
    with pytest.raises(ValueError, match="needs a Clock"):
        ctrl.bind_clock(None)
