"""Checkpoints across backends and the training CLI under a launcher.

Checkpoints stay placement-neutral (the reference's format): on the mesh
every rank gathers, rank 0 writes the whole replica-stacked state, and a
restore keeps each rank's rows.  On the setup8 CNN (R = 8, momentum, 16
steps) the port's ``vmap`` backend saves after 7 steps and a gloo group of
2 CPU processes (``torch_mesh_ranks.py``) finishes on the mesh; the mesh
saves after 7 steps and ``vmap`` finishes — for ADPSGD, for DaSGD with its
correction in flight (snapshot at step 5, due at step 7) and for
``qsgd_periodic`` with its anchor.  The two segments together hold the
uninterrupted ``vmap`` run's schedule exactly; losses rtol 2e-4 / atol
1e-5, S_k rtol 1e-3 / atol 1e-5, the final W rtol 1e-4 / atol 1e-5 (the
mesh's means are means of chunk means).  ``qsgd_periodic`` saved on the
mesh seeded its anchor with the mesh's mean, an ulp from ``vmap``'s,
which moves a level here and there (``test_torch_mesh_strategies.py``):
at most 4 elements a replica of its W may differ by whole quanta, each
within 1e-2 (measured: 3.1e-3, one flip).

The CLI: ``python -m torch.distributed.run --standalone --nproc-per-node 2
-m repro_torch.launch.train --device cpu --backend mesh ... --out F`` on
reduced OLMo writes the history that the same arguments give through
``train.build_engine`` in a group of 2, exactly.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.models.cnn import init_cnn as jax_init_cnn
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.runtime.engine import Checkpointer

METHODS = ["adpsgd", "dasgd", "qsgd_periodic"]
STEPS, HALF = 16, 7
CLI_ARGV = ["--device", "cpu", "--backend", "mesh", "--method", "adpsgd",
            "--steps", "6", "--warmup-sync", "2", "--seq", "32",
            "--replicas", "4", "--batch", "2"]
KEYS = ("sync_steps", "periods", "losses", "s_k")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree_util.tree_map(
        np.asarray, jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16)))


def _sc(method, **kw):
    return dict(dict(kind="train", name=method, model="cnn", method=method,
                     params=_params(), steps=STEPS), **kw)


def _vmap_engine(method):
    return ranks.make_engine(_sc(method, backend="vmap"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_resume")
    out = {"vmap_half": {}, "vmap_tail": {}, "vmap_full": {}}
    for m in METHODS:                       # vmap saves, the mesh resumes
        e = _vmap_engine(m)
        h = e.run(num_steps=HALF)
        out["vmap_half"][m] = dict(ranks.history(e, h),
                                   in_flight=getattr(e.strategy, "_apply_at",
                                                     None))
        Checkpointer(str(tmp / f"vmap-{m}"), 1).save(e, HALF)
    scenarios = ([_sc(m, kind="save_half", name=f"save-{m}", half=HALF,
                      path=str(tmp / f"mesh-{m}")) for m in METHODS]
                 + [_sc(m, kind="resume", name=f"resume-{m}",
                        path=str(tmp / f"vmap-{m}")) for m in METHODS]
                 + [dict(kind="cli", name="cli", argv=CLI_ARGV)])
    group = ranks.Group(2, scenarios, tmp)
    cli_out = tmp / "cli.json"
    env = dict(os.environ, PYTHONPATH=str(ranks.ROOT / "src"),
               OMP_NUM_THREADS="1")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *CLI_ARGV, "--out", str(cli_out)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    for m in METHODS:
        e = _vmap_engine(m)
        out["vmap_full"][m] = ranks.history(e, e.run())
    try:
        out["cli_log"] = launcher.communicate(timeout=ranks.TIMEOUT_S)[0]
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    out["cli_rc"] = launcher.returncode
    out["cli"] = (json.loads(cli_out.read_text()) if cli_out.exists()
                  else None)
    out["mesh"] = group.wait()[0]
    for m in METHODS:                       # the mesh saved, vmap resumes
        e = _vmap_engine(m)
        W, opt_state, meta = load_checkpoint(str(tmp / f"mesh-{m}"), "cpu")
        e.load_state(W, opt_state, strategy_state=meta["controller"],
                     clock_state=meta.get("clock"))
        out["vmap_tail"][m] = dict(
            ranks.history(e, e.run(start_step=meta["step"])),
            meta_step=meta["step"])
    return out


def _hold(first, tail, full, flips=False):
    for k in ("sync_steps", "periods"):
        assert first[k] + tail[k] == full[k], k
    np.testing.assert_allclose(first["losses"] + tail["losses"],
                               full["losses"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(first["s_k"] + tail["s_k"], full["s_k"],
                               rtol=1e-3, atol=1e-5)
    for a, b in zip(tail["W"], full["W"]):
        if flips:
            off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
            assert off.sum() <= 4 * len(a), off.sum()
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-2 if flips else 1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_vmap_to_mesh_resume(runs, method):
    first = runs["vmap_half"][method]
    tail = runs["mesh"][f"resume-{method}"]
    if method == "dasgd":
        assert first["in_flight"] == HALF       # a correction in flight
        assert tail["restored"]["pending"]
    if method == "qsgd_periodic":
        assert tail["restored"]["anchor"]       # no second seeding sync
    _hold(first, tail, runs["vmap_full"][method])


@pytest.mark.parametrize("method", METHODS)
def test_mesh_to_vmap_resume(runs, method):
    first = runs["mesh"][f"save-{method}"]
    tail = runs["vmap_tail"][method]
    assert tail["meta_step"] == HALF
    if method == "dasgd":
        assert first["in_flight"] == HALF
    _hold(first, tail, runs["vmap_full"][method],
          flips=method == "qsgd_periodic")


def test_checkpoint_holds_every_replica(runs):
    """Rank 0 wrote the whole replica axis: the mesh's checkpoint loads
    into a vmap engine of R = 8 (load_state checks the shapes) and its
    first segment's W is the gathered one."""
    first = runs["mesh"]["save-adpsgd"]
    assert all(x.shape[0] == 8 for x in first["W"])
    assert runs["vmap_tail"]["adpsgd"]["meta_step"] == HALF


def test_cli_under_the_launcher(runs):
    assert runs["cli_rc"] == 0, runs["cli_log"][-4000:]
    got, want = runs["cli"], runs["mesh"]["cli"]
    assert got["backend"] == "mesh"
    for k in KEYS:
        assert got[k] == want[k], k
    # rank 0 alone printed the run's summary, naming its mesh
    assert runs["cli_log"].count("[olmo-1b / adpsgd / mesh]") == 1
    assert "'n_devices': 2" in runs["cli_log"]
