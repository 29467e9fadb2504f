"""The mesh's ``replica_tp`` placement (``backends/mesh.py``,
``backends/tp.py``, ``launch/sharding.py``) over gloo groups of CPU
processes (``torch_mesh_ranks.py``), on meshes of data 1 × model 1, data
1 × model 2 and data 2 × model 2: the counterparts of the reference's
``tests/test_placements.py``.

* The matrix: the nine strategies on the CNN (widths (8, 16), R = 8,
  momentum, 16 steps, ``p_init=2``, ``p_const=4``, ``adacomm_interval=8``).
* The families: dense (reduced OLMo-1B) and ssm (reduced xLSTM-350M), the
  reference's ``TIER1_FAMILIES`` cells (R = 4, batch 2, seq 32, momentum,
  lr 0.01, 6 ADPSGD steps).  The other four families (MoE, hybrid, VLM,
  audio) run under the reference's opt-in, ``PLACEMENTS_TRANSFORMER=1``.
* Cross-placement resume both ways: vmap ↔ ``replica_tp`` and
  ``replica_ddp`` ↔ ``replica_tp``.
* Collectives, by group: a local step issues none over the data axis but
  the metrics mean (its gradient norm is summed over the model group), a
  sync's data-axis collectives do not depend on the number of leaves.
* The byte-true quantized sync bitwise the ``vmap`` backend's on the same
  W and anchor, at model sizes 1 and 2; ``hier_adpsgd``'s subgroups of the
  data axis, one set per model index; each rank's local parameter bytes,
  1/m of each sharded leaf; the CLI under ``torch.distributed.run
  --nproc-per-node 4 --placement replica_tp --model-parallel 2``.

Tolerances.  Data 1 × model 1: bitwise the port's ``vmap`` run (made in
the rank).  Model 2: the reference's ``replica_tp`` tolerances against the
reference's ``vmap`` backend (``test_placements.py``): the sync schedule
equal, losses rtol 2e-4 / atol 1e-5, S_k rtol 1e-3 / atol 1e-5, the
CNN's final W rtol 1e-4 / atol 1e-5, the families' losses rtol 5e-4 and
S_k rtol 2e-3.  Row-parallel products sum partial results over the model
ranks, so the rounding differs from one replica's whole product.  The
quantized strategies' W is held as the ``replica_ddp`` matrix holds it
(``test_torch_mesh_strategies.py``): a level whose uniform lies within an
ulp of its fraction may flip, moving a few elements by whole quanta.
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
from repro.backends import VmapBackend as JaxVmapBackend
from repro.configs import AveragingConfig as JaxAvgCfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticImages as JaxImages
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch.steps import make_loss_fn as jax_make_loss_fn
from repro.models import model as jax_model
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import make_lr_schedule as jax_lr
from repro.runtime.engine import TrainerEngine as JaxEngine
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs.base import ParallelismPlan
from repro_torch.interop import params_from_numpy
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as cli_mod
from repro_torch.runtime.engine import Checkpointer
from repro_torch.strategies import available_strategies
from repro_torch.tree import tree_leaves

METHODS = sorted(available_strategies())
MESHES = {1: 1, 2: 2, 4: 2}                     # world -> model size
MESH_IDS = {1: "data1-model1", 2: "data1-model2", 4: "data2-model2"}
FAMILIES = {"dense": "olmo-1b", "moe": "mixtral-8x22b",
            "ssm": "xlstm-350m", "hybrid": "jamba-1.5-large-398b",
            "vlm": "qwen2-vl-2b", "audio": "whisper-medium"}
TIER1 = ("dense", "ssm")
OPT_IN = bool(os.environ.get("PLACEMENTS_TRANSFORMER"))
RUN_FAMILIES = [f for f in FAMILIES if f in TIER1 or OPT_IN]
CNN_AVG = {"adacomm_interval": 8}
HALF = 7
VMAP_ARGV = ["--device", "cpu", "--replicas", "4", "--steps", "8",
             "--warmup-sync", "2", "--seq", "32"]
CLI_ARGV = VMAP_ARGV + ["--backend", "mesh", "--placement", "replica_tp",
                        "--model-parallel", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(model):
    """The reference's initial parameters (numpy): the CNN, or a family's
    reduced config."""
    if model == "cnn16":
        p = jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16))
    else:
        cfg = jax_reduced(jax_get_config(model).model, max_seq_len=32)
        p = jax_model.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _cnn(method, world, **kw):
    return dict(dict(kind="train", name=f"cnn-{method}", model="cnn16",
                     method=method, params=_params("cnn16"),
                     placement="replica_tp", mp=MESHES[world],
                     avg=dict(CNN_AVG), vmap_too=world == 1), **kw)


def _family(fam, world):
    arch = FAMILIES[fam]
    return dict(kind="train", name=f"family-{fam}", model="family",
                arch=arch, method="adpsgd", params=_params(arch),
                placement="replica_tp", mp=MESHES[world],
                vmap_too=world == 1)


def _counts(model, method, **kw):
    params = _params("cnn16" if model == "cnn16" else "olmo-1b")
    return dict(dict(kind="counts", name=f"counts-{model}-{method}",
                     model=model, method=method, params=params, steps=6,
                     placement="replica_tp", mp=2, avg=dict(CNN_AVG)), **kw)


def _jax_cnn(method, group_size=None):
    """The reference's vmap engine on the CNN matrix cell."""
    m = ranks.MODELS["cnn16"]
    avg = dict(ranks.AVG, method=method, **CNN_AVG)
    if group_size:
        avg["group_size"] = group_size
    e = JaxEngine(
        loss_fn=jax_cnn_loss, optimizer=jax_get_optimizer("momentum"),
        params0=jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16)),
        n_replicas=m["R"],
        data_fn=JaxImages(n_samples=256, seed=0).batches(
            n_replicas=m["R"], per_replica_batch=4),
        lr_fn=jax_lr("step", m["lr"], m["steps"], decay_steps=m["decay"]),
        avg_cfg=JaxAvgCfg(**avg), total_steps=m["steps"],
        backend=JaxVmapBackend())
    return _jax_history(e, e.run())


def _jax_family(arch):
    """The reference's ``_family_engine(arch, "vmap")``."""
    cfg = jax_reduced(jax_get_config(arch).model, max_seq_len=32)
    R = ranks.MODELS["family"]["R"]
    base = JaxTokens(cfg.vocab_size, 32, n_samples=64, seed=0).batches(
        n_replicas=R, per_replica_batch=2)
    if cfg.encoder is not None:
        def data_fn(k, _base=base):
            b = dict(_base(k))
            rng = np.random.RandomState(1000 + k)
            b["frames"] = jax.numpy.asarray(0.1 * rng.randn(
                R, 2, cfg.encoder.n_frames, cfg.d_model).astype("float32"))
            return b
    else:
        data_fn = base
    e = JaxEngine(
        loss_fn=jax_make_loss_fn(cfg), optimizer=jax_get_optimizer("momentum"),
        params0=jax_model.init_params(jax.random.PRNGKey(0), cfg),
        n_replicas=R, data_fn=data_fn, lr_fn=lambda k: 0.01,
        avg_cfg=JaxAvgCfg(**ranks.FAMILY_AVG),
        total_steps=ranks.MODELS["family"]["steps"], backend=JaxVmapBackend())
    return _jax_history(e, e.run())


def _jax_history(e, h):
    return {"losses": h.losses, "s_k": h.s_k, "sync_steps": h.sync_steps,
            "periods": h.period_history,
            "inner_sync_steps": h.inner_sync_steps, "n_syncs": h.n_syncs,
            "W": [np.asarray(x) for x in jax.tree_util.tree_leaves(e.W)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tp")
    # vmap -> tp: the port's vmap saves the first half before the groups
    for method in ("adpsgd", "qsgd_periodic"):
        sc = dict(_cnn(method, 4), backend="vmap")
        e = ranks.make_engine(sc)
        e.run(num_steps=HALF)
        Checkpointer(str(tmp / f"vmap-{method}"), 1).save(e, HALF)
    groups = {}
    for world, m in MESHES.items():
        sc = [_cnn(meth, world) for meth in METHODS]
        sc += [_family(f, world) for f in RUN_FAMILIES
               if world > 1 or f == "dense"]
        sc += [dict(kind="exchange", name="exchange", R=8,
                    params=_params("cnn16"), placement="replica_tp", mp=m),
               dict(kind="tp_fallback", name="fallback", mp=m)]
        if world == 4:
            def half(method, placement, name):
                return dict(_cnn(method, 4), kind="save_half", name=name,
                            half=HALF, placement=placement,
                            path=str(tmp / name))

            def resume(method, placement, name, path):
                return dict(_cnn(method, 4), kind="resume", name=name,
                            placement=placement, path=str(tmp / path))
            sc += [_counts("cnn16", "adpsgd"),
                   _counts("olmo", "adpsgd", opt="momentum"),
                   _counts("cnn16", "qsgd_periodic"),
                   _counts("cnn16", "dasgd", steps=16),
                   _counts("cnn16", "hier_adpsgd", steps=16,
                           avg=dict(CNN_AVG, group_size=8)),
                   half("adpsgd", "replica_tp", "tp-adpsgd"),
                   half("dasgd", "replica_tp", "tp-dasgd"),
                   half("adpsgd", "replica_ddp", "ddp-adpsgd"),
                   resume("adpsgd", "replica_tp", "ddp->tp", "ddp-adpsgd"),
                   resume("adpsgd", "replica_ddp", "tp->ddp", "tp-adpsgd"),
                   resume("adpsgd", "replica_tp", "vmap->tp-adpsgd",
                          "vmap-adpsgd"),
                   resume("qsgd_periodic", "replica_tp",
                          "vmap->tp-qsgd_periodic", "vmap-qsgd_periodic")]
        groups[world] = ranks.Group(world, sc, tmp, timeout=300)
    cli_out = tmp / "cli.json"
    env = dict(os.environ, PYTHONPATH=str(ranks.ROOT / "src"),
               OMP_NUM_THREADS="1")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *CLI_ARGV, "--out", str(cli_out)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out = {"jax": {}, "vmap": {}}
    for method in METHODS:
        out["jax"][f"cnn-{method}"] = _jax_cnn(method)
    out["jax"]["hier"] = _jax_cnn("hier_adpsgd", group_size=8)
    for fam in RUN_FAMILIES:
        out["jax"][f"family-{fam}"] = _jax_family(FAMILIES[fam])
    for method in METHODS:
        e = ranks.make_engine(dict(_cnn(method, 4), backend="vmap"))
        out["vmap"][method] = ranks.history(e, e.run())
    e, _ = cli_mod.build_engine(cli_mod.parse_args(VMAP_ARGV))
    out["vmap_cli"] = ranks.history(e, e.run())
    try:
        out["cli_log"] = launcher.communicate(timeout=300)[0]
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    out["cli_rc"] = launcher.returncode
    out["cli"] = (json.loads(cli_out.read_text()) if cli_out.exists()
                  else None)
    for world, group in groups.items():
        got = group.wait()
        out[world], out[f"{world}_all"] = got[0], got
    for method in ("adpsgd", "dasgd"):        # tp saved, vmap resumes
        e = ranks.make_engine(dict(_cnn(method, 4), backend="vmap"))
        W, opt_state, meta = load_checkpoint(str(tmp / f"tp-{method}"),
                                             "cpu")
        e.load_state(W, opt_state, strategy_state=meta["controller"],
                     clock_state=meta.get("clock"))
        out["vmap"][f"tp->vmap-{method}"] = ranks.history(
            e, e.run(start_step=meta["step"]))
    return out


def _close(got, want, *, rtol_loss=2e-4, rtol_s=1e-3, W=True, flips=False):
    for k in ("sync_steps", "periods"):
        assert got[k] == want[k], k
    if "inner_sync_steps" in want:
        assert got["inner_sync_steps"] == want["inner_sync_steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol_loss,
                               atol=1e-5)
    np.testing.assert_allclose(got["s_k"], want["s_k"], rtol=rtol_s,
                               atol=1e-5)
    if not W:
        return
    for a, b in zip(got["W"], want["W"]):
        if flips:
            off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
            assert off.sum() <= 4 * len(a), off.sum()
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-2 if flips else 1e-5)


# --------------------------------------------------------------- the matrix
@pytest.mark.parametrize("method", METHODS)
def test_data1_model1_is_vmap_bitwise(runs, method):
    got = runs[1][f"cnn-{method}"]
    mesh, vmap = got["mesh"], got["vmap"]
    for k in ("sync_steps", "periods", "inner_sync_steps", "losses", "s_k",
              "n_syncs"):
        assert mesh[k] == vmap[k], k
    assert mesh["n_syncs"] >= 4
    for a, b in zip(mesh["W"], vmap["W"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", [2, 4], ids=[MESH_IDS[2], MESH_IDS[4]])
def test_matrix_matches_the_ports_vmap(runs, world, method):
    _close(runs[world][f"cnn-{method}"]["mesh"], runs["vmap"][method],
           flips=method in ("qsgd", "qsgd_periodic"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", [2, 4], ids=[MESH_IDS[2], MESH_IDS[4]])
def test_matrix_matches_the_references_vmap(runs, world, method):
    """QSGD quantizes every step's gradients, and on this cell its loss
    jumps to 30 at step 1: the port's own ``vmap`` run is 4.5e-4 (relative)
    from the reference's here, so QSGD's losses are held to 5e-4 and its
    W to the port's ``vmap`` run (above) alone."""
    _close(runs[world][f"cnn-{method}"]["mesh"],
           runs["jax"][f"cnn-{method}"],
           rtol_loss=5e-4 if method == "qsgd" else 2e-4,
           W=method != "qsgd", flips=method == "qsgd_periodic")


def test_qsgd_gap_to_the_reference_is_the_ports_own(runs):
    """The reason for QSGD's looser bound above: the port's ``vmap`` run
    is as far from the reference's as ``replica_tp`` is, and
    ``replica_tp`` is within 2e-4 of the port's ``vmap`` run."""
    jax_l = np.asarray(runs["jax"]["cnn-qsgd"]["losses"])
    gap = np.max(np.abs(np.asarray(runs["vmap"]["qsgd"]["losses"]) - jax_l)
                 / np.abs(jax_l))
    assert 2e-4 < gap < 5e-4


@pytest.mark.parametrize("world", [2, 4], ids=[MESH_IDS[2], MESH_IDS[4]])
def test_every_rank_keeps_the_same_history(runs, world):
    per_rank = runs[f"{world}_all"]
    for got in per_rank[1:]:
        for method in METHODS:
            a = got[f"cnn-{method}"]["mesh"]
            b = per_rank[0][f"cnn-{method}"]["mesh"]
            for k in ("losses", "s_k", "sync_steps", "periods"):
                assert a[k] == b[k], (method, k)


# ---------------------------------------------------------------- families
FAMILY_CELLS = [(1, "dense")] + [(w, f) for w in (2, 4) for f in FAMILIES]


@pytest.mark.parametrize("world,family", FAMILY_CELLS, ids=[
    f"{MESH_IDS[w]}-{f}" for w, f in FAMILY_CELLS])
def test_family_parity(runs, world, family):
    """At data 1 × model 1 the dense family is bitwise the port's vmap
    run; at model size 2 each family matches the reference's vmap run."""
    if family not in RUN_FAMILIES:
        pytest.skip("the reference's nightly placements-transformer cells "
                    "(set PLACEMENTS_TRANSFORMER=1 to run)")
    got = runs[world][f"family-{family}"]
    if world == 1:
        mesh, vmap = got["mesh"], got["vmap"]
        for k in ("sync_steps", "periods", "losses", "s_k"):
            assert mesh[k] == vmap[k], k
        for a, b in zip(mesh["W"], vmap["W"]):
            np.testing.assert_array_equal(a, b)
        return
    _close(got["mesh"], runs["jax"][f"family-{family}"], rtol_loss=5e-4,
           rtol_s=2e-3, W=False)


# ------------------------------------------------------------ local bytes
@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_bytes_are_the_specs_share(runs, world):
    """Each rank holds 1/m of every leaf the specs shard and the whole of
    every other, as ``param_specs`` over the CNN's tree implies."""
    m = MESHES[world]
    params = params_from_numpy(_params("cnn16"), "meta")
    specs = sh.param_specs(None, params, {"data": world // m, "model": m},
                           ParallelismPlan(), replica_axes=("data",))
    sharded = sum(x.numel() * 4 for x, (_, s) in
                  zip(tree_leaves(params), sh.flat_specs(specs))
                  if sh.model_dim(s) is not None)
    n_local = 8 // (world // m)
    for got in runs[f"{world}_all"]:
        b = got["cnn-adpsgd"]["local_bytes"]
        assert b["m"] == m
        assert b["sharded_whole"] == n_local * sharded > 0
        assert b["local"] == b["whole"] - b["sharded_whole"] \
            + b["sharded_whole"] // m
        if m > 1:
            assert b["local"] < b["whole"]


# ------------------------------------------------------------------ resume
def _hold(tail, full, first=None, flips=False):
    """The resumed second half continues the uninterrupted run: with the
    saved first half, the two histories joined are the run's (DaSGD
    reports a correction's S_k at its snapshot step, so a correction in
    flight at the checkpoint is reported by the second half); without
    it, the second half is the run's from step ``HALF`` on.  The final
    W is the run's."""
    n = sum(s < HALF for s in full["sync_steps"])
    if first is None:
        first = {"sync_steps": full["sync_steps"][:n],
                 "periods": full["periods"][:n], "s_k": full["s_k"][:n],
                 "losses": full["losses"][:HALF]}
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


@pytest.mark.parametrize("way", ["vmap->tp", "tp->vmap", "ddp->tp",
                                 "tp->ddp"])
def test_cross_placement_resume(runs, way):
    """A checkpoint saved under one placement resumes under another and
    continues the uninterrupted run's schedule and losses: checkpoints
    hold whole leaves, and the restoring backend cuts its shards."""
    four = runs[4]
    full = runs["vmap"]["adpsgd"]
    if way == "vmap->tp":
        _hold(four["vmap->tp-adpsgd"], full)
    elif way == "tp->vmap":
        _hold(runs["vmap"]["tp->vmap-adpsgd"], full, four["tp-adpsgd"])
    elif way == "ddp->tp":
        _hold(four["ddp->tp"], full, four["ddp-adpsgd"])
    else:
        _hold(four["tp->ddp"], full, four["tp-adpsgd"])


def test_resume_carries_the_strategy_arrays(runs):
    """DaSGD's in-flight correction, gathered from the shards, resumes on
    the vmap backend; ``qsgd_periodic``'s whole anchor resumes under
    ``replica_tp`` without a second seeding sync."""
    first = runs[4]["tp-dasgd"]
    assert first["in_flight"] == HALF
    _hold(runs["vmap"]["tp->vmap-dasgd"], runs["vmap"]["dasgd"], first)
    tail = runs[4]["vmap->tp-qsgd_periodic"]
    assert tail["restored"]["anchor"]
    _hold(tail, runs["vmap"]["qsgd_periodic"], flips=True)


# ------------------------------------------------------------- collectives
def _by_program(got, name):
    return [(calls, groups, tagged) for (n, calls, tagged), groups in
            zip(got["log"], got["groups"]) if n == name]


@pytest.mark.parametrize("model", ["cnn16", "olmo"])
def test_local_step_issues_no_data_axis_collective(runs, model):
    """The step's one data-axis collective is the metrics mean (a few
    floats, outside the local step); the local step itself sums each
    replica's gradient norm over the model group."""
    got = runs[4][f"counts-{model}-adpsgd"]
    steps = _by_program(got, "step")
    assert len(steps) == 6
    for calls, groups, tagged in steps:
        assert tagged == 1
        data = [c for c, g in zip(calls, groups) if g == "data"]
        assert len(data) == 1 and data[0][0] == "all_reduce"
        assert data[0][1] <= 4 * 8
        assert groups.count("model") == got["n_local"]
        assert set(groups) == {"data", "model"}


def test_sync_collectives_do_not_depend_on_the_leaves(runs):
    cnn = runs[4]["counts-cnn16-adpsgd"]
    olmo = runs[4]["counts-olmo-adpsgd"]
    assert cnn["n_leaves"] < olmo["n_leaves"]
    for got in (cnn, olmo):
        syncs = _by_program(got, "sync")
        assert len(syncs) == got["n_syncs"] >= 2
        for calls, groups, _ in syncs:
            assert [op for op, _ in calls] == ["all_reduce", "all_reduce"]
            assert groups == ["data", "world"]     # the mean bucket, S_k
            assert calls[1][1] == 4


def test_quantized_and_dasgd_collectives(runs):
    """A quantized sync: one all-gather over the model group (the whole
    leaves, bucketed) and one over the data group (the int8 payload);
    DaSGD: the snapshot's all-reduce over the data group, S_k's over the
    world."""
    got = runs[4]["counts-cnn16-qsgd_periodic"]
    syncs = _by_program(got, "sync")
    assert len(syncs) >= 3
    for calls, groups, _ in syncs[1:]:
        assert [op for op, _ in calls] == ["all_gather_into_tensor",
                                           "all_gather"]
        assert groups == ["model", "data"]
    got = runs[4]["counts-cnn16-dasgd"]
    for name, want in (("sync", ["data"]), ("sync_apply", ["world"])):
        progs = _by_program(got, name)
        assert progs and all(g == want for _, g, _ in progs), name


@pytest.mark.parametrize("world", [1, 2, 4])
def test_quantized_sync_bitwise(runs, world):
    """The byte-true exchange on the same (W, anchor, key) is bitwise the
    vmap backend's at model sizes 1 and 2: the leaves are made whole
    before they are quantized, and each rank keeps its shard."""
    got = runs[world]["exchange"]
    mesh, vmap = got["mesh"], got["vmap"]
    assert mesh["s_k"] == vmap["s_k"]
    for a, b in zip(mesh["anchor"], vmap["anchor"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mesh["W"], vmap["W"]):
        np.testing.assert_array_equal(a, b)


def test_hier_groups_per_model_index(runs):
    """Groups of 8 replicas at data 2 × model 2 (4 a data index) span two
    data indices: one subgroup of the data axis per model index."""
    got = runs[4]["counts-cnn16-hier_adpsgd"]
    _close(got, runs["jax"]["hier"])
    assert got["inner_sync_steps"]
    for rank, res in enumerate(runs["4_all"]):
        assert res["counts-cnn16-hier_adpsgd"]["subgroups"] == {
            2: [rank % 2, rank % 2 + 2]}
    inner = _by_program(got, "inner_sync")
    assert inner and all(g == ["sub"] for _, g, _ in inner)


# --------------------------------------------------------------------- CLI
def test_cli_under_the_launcher(runs):
    assert runs["cli_rc"] == 0, runs["cli_log"][-4000:]
    got, want = runs["cli"], runs["vmap_cli"]
    assert got["backend"] == "mesh"
    for k in ("sync_steps", "periods"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["s_k"], want["s_k"], rtol=2e-3,
                               atol=1e-5)
    assert runs["cli_log"].count("[olmo-1b / adpsgd / mesh]") == 1
    assert "'placement': 'replica_tp', 'model_parallel': 2" in \
        runs["cli_log"]


# ---------------------------------------------------------------- fallback
@pytest.mark.parametrize("world", [1, 2, 4])
def test_refused_functions_run_on_whole_operands(runs, world):
    """A function DTensor has no strategy for (``Tensor.unfold`` on a
    column-sharded leaf), and an einsum with a sharded operand, run on
    whole operands: the loss, its aux and the gradients are the plain
    computation's."""
    got = runs[world]["fallback"]
    assert got["whole"] == {"unfold": 1, "einsum": 1}
    np.testing.assert_allclose(got["loss"], got["plain_loss"], rtol=1e-6)
    np.testing.assert_allclose(got["u"], got["plain_u"], rtol=1e-6)
    for a, b in zip(got["grads"], got["plain_grads"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
