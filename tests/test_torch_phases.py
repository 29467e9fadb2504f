"""The phase recorder (``repro_torch/runtime/phases.py``): phase spans
inside the local step (forward, backward, optimizer a replica), the
engine loop (data, keys, readback, observe) and the mesh's collectives
(metrics_allreduce every step, allreduce every sync).  Off it costs no
clock read, no CUDA event and no allocation; on it changes no number of
the run; it records under a ``WallClock`` (``by_phase`` of the timing
summary) and inside a ``torch.profiler`` session."""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.backends import make_backend
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_to_numpy
from repro_torch.models import model as M
from repro_torch.runtime import clock as clk
from repro_torch.runtime import phases as ph
from repro_torch.tree import tree_leaves

STEP_PHASES = ("forward", "backward", "optimizer")
LOOP_PHASES = ("data", "keys", "readback", "observe")


@pytest.fixture(scope="module")
def olmo_params():
    cfg = reduced(get_config("olmo-1b").model, max_seq_len=32)
    return params_to_numpy(M.init_params(0, cfg, device="cpu"))


def _sc(params, R=2, steps=4, **kw):
    return dict(kind="phases", name="phases", model="olmo", method="adpsgd",
                params=params, R=R, steps=steps, **kw)


def _vmap_run(sc, on: bool, clock=None):
    engine = ranks.make_engine(sc, make_backend("vmap", device="cpu"),
                               clock=clock)
    engine.phases.on = on or engine.phases.on
    return engine, engine.run()


def _state(engine, hist):
    return ([x.clone() for x in tree_leaves((engine.W, engine.opt_state))],
            list(hist.losses), list(hist.s_k))


def _counts(records):
    out = {}
    for r in records:
        c = out.setdefault(r.k, {})
        c[r.name] = c.get(r.name, 0) + 1
    return out


def test_off_is_free(olmo_params, monkeypatch):
    """Off, a 3-iteration run reads no clock in a phase, makes no CUDA
    event and records nothing; ``phase`` hands out one shared no-op."""
    def refuse(*a, **k):
        raise AssertionError("called with the recorder off")
    monkeypatch.setattr(ph, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    engine, hist = _vmap_run(_sc(olmo_params, steps=3), on=False)
    assert len(hist.losses) == 3 and hist.s_k
    assert engine.phases.records == []
    assert engine.phases.phase("forward") is ph.NOOP
    assert engine.backend.phases is engine.phases


def test_on_is_bitwise_off_vmap(olmo_params):
    """R = 2 on the vmap backend: W, the optimizer state, the losses and
    S_k bitwise equal with the recorder on and off."""
    sc = _sc(olmo_params, steps=4)
    off = _state(*_vmap_run(sc, on=False))
    on_engine, on_hist = _vmap_run(sc, on=True)
    on = _state(on_engine, on_hist)
    assert on_engine.phases.records
    assert on[1] == off[1] and on[2] == off[2] and off[2]
    assert len(on[0]) == len(off[0])
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)


def test_on_records_the_phases_vmap(olmo_params):
    """Every iteration records forward, backward and optimizer once a
    replica, and the loop's data, keys, readback and observe; each record
    carries its iteration and a host interval (no device time on the
    CPU)."""
    R, steps = 2, 4
    engine, hist = _vmap_run(_sc(olmo_params, R=R, steps=steps), on=True)
    counts = _counts(engine.phases.records)
    assert sorted(counts) == list(range(steps))
    for k, c in counts.items():
        for name in STEP_PHASES:
            assert c[name] == R, (k, c)
        for name in LOOP_PHASES:
            assert c.get(name, 0) >= 1, (k, c)
        # a key a step, one an action
        assert c["keys"] == 1 + (2 if k in hist.sync_steps else 1)
    for r in engine.phases.records:
        assert r.t1_ns >= r.t0_ns and r.device_ms is None
        assert not r.traced


def test_profiler_session_records_traced(olmo_params):
    """With the recorder off, a ``torch.profiler`` session records the
    phases of the iterations it holds, marked traced and listed for
    ``traced_records``; after it, nothing is recorded."""
    engine = ranks.make_engine(_sc(olmo_params, steps=3),
                               make_backend("vmap", device="cpu"))
    engine.run(0, 1)
    assert engine.phases.records == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.run(1, 1)
    n = len(engine.phases.records)
    engine.run(2, 1)
    assert len(engine.phases.records) == n > 0
    recs = engine.phases.records
    assert all(r.traced and r.k == 1 for r in recs)
    traced = ph.traced_records()
    assert all(any(r is t for t in traced) for r in recs)
    assert set(_counts(recs)[1]) >= set(STEP_PHASES + LOOP_PHASES)


def test_operator_summary_by_phase(olmo_params):
    """A ``WallClock`` switches the recorder on, and the timing summary
    (``TrainHistory.timing``) carries the phases' totals under
    ``by_phase`` beside ``by_program``; a simulated clock leaves both the
    recorder and the summary as they were."""
    engine, hist = _vmap_run(_sc(olmo_params, steps=3), on=False,
                             clock=clk.WallClock())
    assert engine.phases.on
    by = hist.timing["by_phase"]
    assert set(by) >= set(STEP_PHASES + LOOP_PHASES)
    assert by["forward"]["calls"] == 3 * 2
    assert all(v["host_s"] >= 0 and "device_s" not in v for v in by.values())
    assert "by_program" in hist.timing
    engine, hist = _vmap_run(_sc(olmo_params, steps=3), on=False,
                             clock=clk.SimulatedClock("10gbps"))
    assert not engine.phases.on and "by_phase" not in hist.timing


def test_summary_sums_records():
    """``summary`` adds calls, host and device seconds by name."""
    rec = ph.PhaseRecorder()
    rec.records += [ph.PhaseRecord("forward", 0, 0, 2_000_000, 1.5),
                    ph.PhaseRecord("forward", 1, 5, 1_000_005, 0.5),
                    ph.PhaseRecord("data", 1, 0, 3_000_000)]
    got = rec.summary()
    assert got["forward"] == {"calls": 2, "host_s": 0.003, "device_s": 0.002}
    assert got["data"] == {"calls": 1, "host_s": 0.003}


@pytest.fixture(scope="module")
def gloo_runs(olmo_params, tmp_path_factory):
    """Reduced OLMo-1B, ADPSGD, R = 4 on 2 gloo ranks (``replica_ddp``, 2
    replicas a rank), 4 steps, recorder off then on; a time limit of its
    own."""
    sc = _sc(olmo_params, R=4, steps=4, backend="mesh")
    return ranks.Group(2, [sc], tmp_path_factory.mktemp("phases"),
                       timeout=120).wait()


def test_on_is_bitwise_off_mesh(gloo_runs):
    for got in gloo_runs:
        off, on = got["phases"][False], got["phases"][True]
        assert off["counts"] == {} and on["counts"]
        for key in ("losses", "s_k", "sync_steps", "periods"):
            assert on[key] == off[key], key
        assert off["s_k"]
        for a, b in zip(on["W"] + on["opt"], off["W"] + off["opt"]):
            np.testing.assert_array_equal(a, b)


def test_mesh_records_its_collectives(gloo_runs):
    """Each rank records forward, backward and optimizer once a local
    replica, metrics_allreduce every step and allreduce every sync."""
    for got in gloo_runs:
        on = got["phases"][True]
        assert sorted(on["counts"]) == list(range(4))
        for k, c in on["counts"].items():
            for name in STEP_PHASES:
                assert c[name] == 2, (k, c)
            assert c["metrics_allreduce"] == 1, (k, c)
            assert c.get("allreduce", 0) == (1 if k in on["sync_steps"]
                                              else 0), (k, c)
            for name in LOOP_PHASES:
                assert c.get(name, 0) >= 1, (k, c)
