"""Checkpoint / resume in the port (``checkpoint/io.py``, the strategies'
state hooks, ``Checkpointer`` and ``TrainerEngine.load_state``).

On the test CNN (R = 4, widths (8, 16), momentum, 16 steps, CPU), every
strategy resumes bit for bit: the uninterrupted run saves at step 7, and a
fresh engine loaded from that checkpoint and run on for 9 steps gives the
run's tail exactly — sync steps, periods, losses, S_k, the final W, the
optimizer, strategy and clock state.  DaSGD is saved with a
correction in flight, AdaComm in time mode mid-block under a
SimulatedClock.  The reference's other resume cases follow: the export
checkpoint is refused, a params0-less engine resumes, ``Checkpointer``
saves post-sync state, ``n_syncs`` counts per segment.

Across frameworks, on reduced OLMo (vmap, adamw, adpsgd): the reference
saves at step 8 and the port finishes; the port saves at step 8 and the
reference finishes.  Each is held to the reference's uninterrupted run —
the identical sync schedule, losses and S_k within rtol 1e-4, W within
0.05·lr (the bound ``test_torch_engine.py`` states).  The reference's
``load_checkpoint`` drops empty dicts (OLMo's parameterless norms), so
its side grafts the loaded leaves into its engine's own tree.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.backends import VmapBackend as JaxVmapBackend
from repro.checkpoint import io as jax_io
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch.steps import make_loss_fn as jax_make_loss_fn
from repro.models import model as jax_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import make_lr_schedule as jax_lr
from repro.runtime.engine import Callback as JaxCallback
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro_torch.backends import VmapBackend
from repro_torch.checkpoint import io
from repro_torch.configs import AveragingConfig, get_config, reduced
from repro_torch.core import averaging as avg
from repro_torch.data.pipeline import SyntheticImages, SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models.cnn import cnn_loss, init_cnn
from repro_torch.optim import get_optimizer, make_lr_schedule
from repro_torch.runtime import clock as clk
from repro_torch.runtime.engine import Callback, Checkpointer, TrainerEngine
from repro_torch.strategies import available_strategies
from repro_torch.tree import tree_leaves

# the CNN's runs save after 7 steps, between DaSGD's snapshot at step 5
# and its apply at step 7; the OLMo runs save after 8
R, STEPS, HALF = 4, 16, 7
AVG = dict(p_init=2, p_const=4, k_sample_frac=0.25, warmup_full_sync_steps=2,
           inner_period=2, adacomm_interval=4)
METHODS = ["adpsgd", "cpsgd", "decreasing", "fullsgd", "qsgd",
           "qsgd_periodic", "hier_adpsgd", "dasgd", "adacomm_time"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cnn():
    return (init_cnn(0, widths=(8, 16), device="cpu"),
            SyntheticImages(n_samples=128, seed=0))


def _cfg(method):
    if method == "adacomm_time":
        # t0 = 0.012 simulated s: blocks of about 2 steps at 10 Gbps
        return AveragingConfig(**AVG, method="adacomm", adacomm_mode="time",
                               adacomm_t0=0.012)
    return AveragingConfig(**AVG, method=method)


def _engine(cnn, method, params0=True, callbacks=()):
    p0, data = cnn
    return TrainerEngine(
        loss_fn=cnn_loss, optimizer=get_optimizer("momentum"),
        params0=p0 if params0 else None, n_replicas=R,
        data_fn=data.batches(n_replicas=R, per_replica_batch=4,
                             device="cpu"),
        lr_fn=make_lr_schedule("step", 0.05, STEPS, decay_steps=(12,)),
        avg_cfg=_cfg(method), total_steps=STEPS,
        clock=(clk.SimulatedClock("10gbps") if method == "adacomm_time"
               else None),
        callbacks=list(callbacks), device="cpu")


def _save(engine, path, step):
    io.save_checkpoint(path, engine.W, opt_state=engine.opt_state, step=step,
                       controller_state=io.strategy_state(engine.strategy),
                       clock_state=(engine.clock.state_dict()
                                    if engine.clock else None))


def _resume(engine, path):
    W, opt_state, meta = io.load_checkpoint(path, device="cpu")
    engine.load_state(W, opt_state, strategy_state=meta["controller"],
                      clock_state=meta.get("clock"))
    return meta


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


class _SaveAt(Callback):
    """Save through ``Checkpointer.save`` once, at the end of iteration
    ``step - 1``, and note how many syncs the history held then."""

    def __init__(self, path, step):
        self.ckpt, self.step, self.n_sync = Checkpointer(path, 1), step, None

    def on_iteration_end(self, engine, k, metrics):
        if k + 1 == self.step:
            self.ckpt.save(engine, self.step)
            self.n_sync = len(engine.history.sync_steps)
            self.n_events = engine.strategy.n_comm_events
            self.inflight = getattr(engine.strategy, "_apply_at", None)
            ctl = engine.strategy.__dict__.get("controller")
            self.loss_n = getattr(ctl, "_loss_n", None)


def _state(strategy):
    """The strategy's json state and its arrays as numpy."""
    d = strategy.state_dict()
    arrays = d.pop("_arrays", {})
    return d, {k: [x.numpy() for x in tree_leaves(v)]
               for k, v in arrays.items()}


@pytest.mark.parametrize("method", METHODS)
def test_mid_run_resume_is_bit_exact(cnn, method, tmp_path):
    """The uninterrupted run saves at step 7 (a checkpoint is only a
    fetch, so the run goes on unchanged); a fresh engine resumes from it,
    and the histories' tails, W, the optimizer and strategy state and the
    clock agree exactly."""
    path = str(tmp_path / "ckpt")
    saver = _SaveAt(path, HALF)
    full = _engine(cnn, method, callbacks=[saver])
    h_full = full.run()
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == HALF and meta["controller"]["strategy"] == \
        full.strategy.name
    has_arrays = os.path.exists(os.path.join(path, "strategy_arrays.npz"))
    assert has_arrays == (method in ("qsgd_periodic", "dasgd"))
    if method == "dasgd":
        # saved between a snapshot and its apply
        assert saver.inflight is not None and meta["controller"]["apply_at"] \
            == saver.inflight >= HALF
    if method == "adacomm_time":
        assert saver.loss_n > 0                             # mid-block
        assert meta["clock"]["kind"] == "sim"

    resumed = _engine(cnn, method)
    _resume(resumed, path)
    h_res = resumed.run(start_step=HALF)
    n = saver.n_sync
    assert h_res.losses == h_full.losses[HALF:]
    assert h_res.sync_steps == h_full.sync_steps[n:]
    assert h_res.period_history == h_full.period_history[n:]
    assert h_res.s_k == h_full.s_k[n:]
    assert h_res.inner_sync_steps == [k for k in h_full.inner_sync_steps
                                      if k >= HALF]
    assert h_res.n_syncs == h_full.n_syncs - saver.n_events >= 2
    assert _same_tree(resumed.W, full.W)
    assert _same_tree(resumed.opt_state, full.opt_state)
    got, want = _state(resumed.strategy), _state(full.strategy)
    assert got[0] == want[0]
    for k in want[1]:
        assert all(np.array_equal(a, b) for a, b in zip(got[1][k], want[1][k]))
    if resumed.clock is not None:
        assert resumed.clock.now() == full.clock.now()


def test_all_strategies_covered():
    assert sorted({m.replace("_time", "") for m in METHODS}) == \
        sorted(available_strategies())


def test_export_checkpoint_is_refused(cnn, tmp_path):
    e = _engine(cnn, "cpsgd", callbacks=[
        Checkpointer(str(tmp_path / "export"), every=6, keep_replicas=False)])
    e.run(num_steps=6)
    W, opt_state, meta = io.load_checkpoint(str(tmp_path / "export"),
                                            device="cpu")
    assert opt_state is None
    for got, w in zip(tree_leaves(W), tree_leaves(avg.replica_mean(e.W))):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="export-only"):
        _engine(cnn, "cpsgd").load_state(W)
    with pytest.raises(ValueError, match="export-only"):
        _engine(cnn, "cpsgd", params0=False).load_state(W)


def test_params0less_engine_resumes(cnn, tmp_path):
    """Without params0 the engine takes the checkpoint's tree: with the
    optimizer state it resumes bit for bit; without it, it starts a fresh
    optimizer state and runs."""
    saver = _SaveAt(str(tmp_path / "ck"), HALF)
    full = _engine(cnn, "adpsgd", callbacks=[saver])
    h_full = full.run()
    e = _engine(cnn, "adpsgd", params0=False)
    with pytest.raises(RuntimeError, match="load_state"):
        e.run()
    _resume(e, str(tmp_path / "ck"))
    h = e.run(start_step=HALF)
    assert h.losses == h_full.losses[HALF:]
    assert h.s_k == h_full.s_k[saver.n_sync:]
    assert _same_tree(e.W, full.W)

    half = _engine(cnn, "cpsgd")
    half.run(num_steps=HALF)
    e = _engine(cnn, "cpsgd", params0=False)
    e.load_state(half.W)                   # no optimizer state
    assert all(not x.any() for x in tree_leaves(e.opt_state))
    h = e.run(start_step=HALF, num_steps=4)
    assert len(h.losses) == 4 and np.isfinite(h.losses).all()


def test_checkpointer_saves_post_sync_state(cnn, tmp_path):
    """cpsgd, p 4, warm-up 2: step 5 syncs and (5 + 1) % 6 == 0 saves, so
    the checkpoint holds the averaged W (replicas equal) and the
    post-observe schedule, and resumes bit for bit."""
    path = str(tmp_path / "cb")
    e = _engine(cnn, "cpsgd", callbacks=[Checkpointer(path, every=6)])
    e.run(num_steps=6)
    assert 5 in e.history.sync_steps
    W, opt_state, meta = io.load_checkpoint(path, device="cpu")
    assert meta["step"] == 6
    for x in tree_leaves(W):
        assert torch.equal(x, x[:1].expand_as(x))
    h_full = _engine(cnn, "cpsgd").run()
    res = _engine(cnn, "cpsgd")
    res.load_state(W, opt_state, strategy_state=meta["controller"])
    h_res = res.run(start_step=6)
    assert h_res.losses == h_full.losses[6:]
    assert h_res.sync_steps == [s for s in h_full.sync_steps if s >= 6]


def test_n_syncs_counts_per_segment(cnn, tmp_path):
    half = _engine(cnn, "fullsgd")
    assert half.run(num_steps=HALF).n_syncs == HALF
    _save(half, str(tmp_path / "ck"), HALF)
    res = _engine(cnn, "fullsgd")
    _resume(res, str(tmp_path / "ck"))
    assert res.strategy.n_comm_events == HALF
    assert res.run(start_step=HALF).n_syncs == STEPS - HALF


def test_load_state_copies_into_fresh_buffers(cnn, tmp_path):
    """The programs write W in place: a loaded tree used twice gives two
    identical runs."""
    half = _engine(cnn, "cpsgd")
    half.run(num_steps=HALF)
    _save(half, str(tmp_path / "ck"), HALF)
    W, opt_state, meta = io.load_checkpoint(str(tmp_path / "ck"),
                                            device="cpu")
    runs = []
    for _ in range(2):
        e = _engine(cnn, "cpsgd")
        e.load_state(W, opt_state, strategy_state=meta["controller"])
        runs.append(e.run(start_step=HALF).losses)
    assert runs[0] == runs[1]
    assert _same_tree(W, half.W)


def test_npz_is_what_numpy_writes(tmp_path):
    """The streamed archive holds what ``np.savez`` writes for the same
    arrays: the same members with the same bytes."""
    import zipfile
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.int32), torch.zeros(())],
            "c": {"d": torch.full((3,), 2.5)}}
    io._write_npz(str(tmp_path / "mine.npz"), tree)
    np.savez(str(tmp_path / "numpy.npz"), **{
        k: v.numpy() for k, v in io._flatten(tree).items()})
    with zipfile.ZipFile(tmp_path / "mine.npz") as a, \
            zipfile.ZipFile(tmp_path / "numpy.npz") as b:
        assert a.namelist() == b.namelist() == [
            "a.npy", "b|#0.npy", "b|#1.npy", "c|d.npy"]
        for name in a.namelist():
            assert a.read(name) == b.read(name)
    back = io._read_npz(str(tmp_path / "mine.npz"), torch.device("cpu"))
    assert _same_tree(back, tree)


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    io.save_checkpoint(str(tmp_path), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        io.load_checkpoint(str(tmp_path))


def test_restore_refuses_another_strategy(cnn, tmp_path):
    half = _engine(cnn, "cpsgd")
    half.run(num_steps=2)
    _save(half, str(tmp_path / "ck"), 2)
    with pytest.raises(ValueError, match="cpsgd"):
        _resume(_engine(cnn, "adpsgd"), str(tmp_path / "ck"))


# ------------------------------------------------------------ across frameworks
OLMO_LR, OLMO_HALF = 4e-4, 8


class _JaxSaveAt(JaxCallback):
    def __init__(self, path, step):
        self.path, self.step = path, step

    def on_iteration_end(self, engine, k, metrics):
        if k + 1 == self.step:
            jax_io.save_checkpoint(
                self.path, engine.W, opt_state=engine.opt_state, step=k + 1,
                controller_state=jax_io.strategy_state(engine.strategy))


@pytest.fixture(scope="module")
def olmo(tmp_path_factory):
    """The reference's uninterrupted run (saving at step 8), the port from
    that checkpoint, and the reference from the port's step-8 checkpoint."""
    root = tmp_path_factory.mktemp("olmo")
    jcfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=32)
    tcfg = reduced(get_config("olmo-1b").model, max_seq_len=32)
    params0 = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    jdata = JaxTokens(jcfg.vocab_size, 32, n_samples=R * 4 * 64, seed=0)
    tdata = SyntheticTokens(tcfg.vocab_size, 32, n_samples=R * 4 * 64, seed=0)
    avg_kw = dict(AVG, method="adpsgd")

    def jax_engine(callbacks=()):
        return JaxEngine(
            loss_fn=jax_make_loss_fn(jcfg),
            optimizer=jax_get_optimizer("adamw"), params0=params0,
            n_replicas=R,
            data_fn=jdata.batches(n_replicas=R, per_replica_batch=4),
            lr_fn=jax_lr("step", OLMO_LR, STEPS, decay_steps=(8, 12)),
            avg_cfg=JaxAvgCfg(**avg_kw), total_steps=STEPS,
            backend=JaxVmapBackend(use_kernel=True), callbacks=callbacks)

    def torch_engine():
        return TrainerEngine(
            loss_fn=make_loss_fn(tcfg), optimizer=get_optimizer("adamw"),
            params0=params_from_numpy(params0, "cpu"), n_replicas=R,
            data_fn=tdata.batches(n_replicas=R, per_replica_batch=4,
                                  device="cpu"),
            lr_fn=make_lr_schedule("step", OLMO_LR, STEPS,
                                   decay_steps=(8, 12)),
            avg_cfg=AveragingConfig(**avg_kw), total_steps=STEPS,
            backend=VmapBackend(use_kernel=True, device="cpu"))

    ref_ckpt, port_ckpt = str(root / "ref"), str(root / "port")
    jfull = jax_engine([_JaxSaveAt(ref_ckpt, OLMO_HALF)])
    h_ref = jfull.run()

    port = torch_engine()
    _resume(port, ref_ckpt)
    h_port_tail = port.run(start_step=OLMO_HALF)

    first = torch_engine()
    first.run(num_steps=OLMO_HALF)
    _save(first, port_ckpt, OLMO_HALF)
    jres = jax_engine()
    W, opt_state, meta = jax_io.load_checkpoint(port_ckpt)

    def graft(like, tree):
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like), jax.tree_util.tree_leaves(tree))

    jres.load_state(graft(jres.W, W), graft(jres.opt_state, opt_state),
                    strategy_state=meta["controller"])
    h_ref_tail = jres.run(start_step=OLMO_HALF)
    return dict(ref=h_ref, tails={
        "reference_to_port": (h_port_tail, tree_leaves(port.W)),
        "port_to_reference": (h_ref_tail,
                              jax.tree_util.tree_leaves(jres.W))})


@pytest.mark.parametrize("way", ["reference_to_port", "port_to_reference"])
def test_cross_framework_resume(olmo, way):
    ref = olmo["ref"]
    tail, W = olmo["tails"][way]
    n = len([s for s in ref.sync_steps if s >= OLMO_HALF])
    assert n >= 2
    assert tail.sync_steps == ref.sync_steps[-n:]
    assert tail.period_history == ref.period_history[-n:]
    assert tail.n_syncs == n
    np.testing.assert_allclose(tail.losses, ref.losses[OLMO_HALF:], rtol=1e-4)
    np.testing.assert_allclose(tail.s_k, ref.s_k[-n:], rtol=1e-4)
    want = jax.tree_util.tree_leaves(ref.final_W)
    assert len(W) == len(want)
    for g, w in zip(W, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=0.05 * OLMO_LR, rtol=0)


def test_archive_reads_are_np_loads(tmp_path):
    """The archive reader (a stored member straight into its array, a few
    members at once) gives ``np.load``'s arrays for what ``np.savez``
    writes: C and Fortran order, 0-d, empty, several dtypes; a flipped
    byte fails the member's CRC-32, and a compressed archive is refused."""
    import zipfile
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 5).astype(np.float32),
            "f": np.asfortranarray(rng.randn(4, 6)),
            "s": [np.float32(2.5), np.array(7, dtype=np.int64)],
            "e": np.zeros((0, 3), np.int8)}
    path = str(tmp_path / "a.npz")
    np.savez(path, **io._flatten(tree))
    got = io._flatten(io._read_npz(path, torch.device("cpu")))
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and \
            np.array_equal(got[k].numpy(), v), k
    raw = bytearray(open(path, "rb").read())
    at = raw.find(tree["w"].tobytes())
    raw[at + 3] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        io._read_npz(path, torch.device("cpu"))
    packed = str(tmp_path / "c.npz")
    np.savez_compressed(packed, **io._flatten(tree))
    with pytest.raises(ValueError, match="compressed"):
        io._read_npz(packed, torch.device("cpu"))
