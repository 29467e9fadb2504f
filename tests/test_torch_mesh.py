"""The port's mesh backend (``backends/mesh.py``, ``launch/mesh.py``): the
registry and its guards, and ADPSGD over gloo groups of 1, 2 and 4 CPU
processes against the port's ``vmap`` backend and the reference's.

The ranks run in processes of their own (``torch_mesh_ranks.py``: the
port alone, one torch thread each); one group per world size runs all of
this module's scenarios.  Models: the reference's setup8 CNN
(``tests/test_backends.py``: widths (8, 16), R = 8, momentum, 24 steps)
and a narrow OLMo (reduced olmo-1b, 2 layers, d_model 128, R = 4, adamw,
16 steps), both from the reference's initial parameters.

Tolerances.  World 1: bitwise the ``vmap`` backend's run, made in the
same process (same thread count), on the plain route and with the sync
kernel on (its CPU route).  Worlds 2 and 4: the identical sync schedule;
losses rtol 2e-4 / atol 1e-5 and S_k rtol 1e-3 / atol 1e-5 (the
reference's matrix tolerances, ``test_placements.py``); the final W rtol
1e-4 / atol 1e-5 with momentum, atol 0.05·lr with adamw (the bound
``test_torch_engine.py`` states: adamw divides by sqrt(v), so a rounding
of a near-zero gradient becomes a visible share of a step), against the
port's ``vmap`` and the reference's.  The mesh's means are means of the
ranks' chunk means, a different order of summation from one mean over R.
"""
import functools

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
from repro_torch.backends import (MeshBackend, available_backends,
                                  get_backend_cls, make_backend)
from repro_torch.configs.base import ParallelismPlan
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train

MODELS = ("cnn", "olmo")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(model):
    if model == "cnn":
        return jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16))
    cfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=32)
    return jax_model.init_params(jax.random.PRNGKey(0), cfg)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(model):
    """The reference's vmap engine on the same model, data and schedule."""
    m = ranks.MODELS[model]
    R = m["R"]
    if model == "cnn":
        loss = jax_cnn_loss
        data = JaxImages(n_samples=256, seed=0)
    else:
        cfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=32)
        loss = jax_make_loss_fn(cfg)
        data = JaxTokens(cfg.vocab_size, 32, n_samples=R * 4 * 64, seed=0)
    eng = JaxEngine(
        loss_fn=loss, optimizer=jax_get_optimizer(m["opt"]),
        params0=_jax_params(model), n_replicas=R,
        data_fn=data.batches(n_replicas=R, per_replica_batch=4),
        lr_fn=jax_lr("step", m["lr"], m["steps"], decay_steps=m["decay"]),
        avg_cfg=JaxAvgCfg(**ranks.AVG, method="adpsgd"),
        total_steps=m["steps"], backend=JaxVmapBackend())
    h = eng.run()
    return {"losses": h.losses, "s_k": h.s_k, "sync_steps": h.sync_steps,
            "periods": h.period_history,
            "W": [np.asarray(x) for x in jax.tree_util.tree_leaves(eng.W)]}


def _scenario(model, **kw):
    return dict(kind="train", name=f"{model}-{kw.get('use_kernel')}",
                model=model, method="adpsgd",
                params=_numpy(_jax_params(model)), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 (mesh and vmap in the rank, both routes), worlds 2 and 4
    (mesh; world 4 also the topology checks, with two nodes of two GPUs
    for the production mesh), the port's vmap runs in this process and
    the reference's."""
    tmp = tmp_path_factory.mktemp("mesh")
    one = [_scenario(m, use_kernel=k, vmap_too=True)
           for m in MODELS for k in (None, True)]
    many = [_scenario(m) for m in MODELS]
    topo = [dict(kind="topology", name="topology", per_node=2)]
    groups = {1: ranks.Group(1, one, tmp),
              2: ranks.Group(2, many, tmp),
              4: ranks.Group(4, many + topo, tmp)}
    out = {}
    for m in MODELS:
        e = ranks.make_engine(dict(_scenario(m), backend="vmap"))
        out[f"vmap-{m}"] = ranks.history(e, e.run())
        out[f"jax-{m}"] = _jax_run(m)
    for world, group in groups.items():
        got = group.wait()
        out[f"world{world}"] = got[0]
        out[f"world{world}_all"] = got
    return out


# ------------------------------------------------------------------ guards
def test_registry():
    assert "mesh" in available_backends()
    assert get_backend_cls("mesh") is MeshBackend
    with pytest.raises(KeyError):
        make_backend("nope")


def test_unknown_placement_is_refused():
    with pytest.raises(ValueError, match="unknown placement"):
        MeshBackend(placement="replica_fsdp", device="cpu")


@pytest.mark.parametrize("how", ["backend_tp", "backend_mp2", "host_mesh",
                                 "plan", "cli_tp", "cli_mp2"])
def test_replica_tp_builds(runs, how):
    """The calls that named ``replica_tp`` as the next slice now build it:
    at world 4 the backend's default model axis is 2 (the reference's
    default for an even world), ``model_parallel=2`` lays the ranks out
    as 2 × 2 (rank r: data r // 2, model r % 2), and the CLI parses both
    flags with ``--backend mesh``."""
    if how == "plan":
        plan = ParallelismPlan(placement="replica_tp",
                               vocab_parallel_embed=False)
        assert plan.placement == "replica_tp"
        return
    if how.startswith("cli"):
        flags = (["--placement", "replica_tp"] if how == "cli_tp"
                 else ["--model-parallel", "2"])
        args = train.parse_args(["--backend", "mesh"] + flags)
        assert (args.placement, args.model_parallel) == (
            ("replica_tp", 0) if how == "cli_tp" else ("replica_ddp", 2))
        return
    for rank, got in enumerate(runs["world4_all"]):
        t = got["topology"]
        if how == "backend_tp":
            d = t["tp_describe"]
            assert (d["placement"], d["model_parallel"]) == ("replica_tp", 2)
            assert d["mesh"] == {"data": 2, "model": 2}
            assert t["tp_replicas"] == list(range(4 * (rank // 2),
                                                  4 * (rank // 2) + 4))
        elif how == "backend_mp2":
            d = t["mp2_describe"]
            assert (d["placement"], d["model_parallel"]) == ("replica_ddp", 2)
        else:
            assert t["host_shape"] == {"data": 2, "model": 2}
            assert t["host_index"] == (rank // 2, rank % 2)
            assert t["host_model_ranks"] == [2 * (rank // 2),
                                             2 * (rank // 2) + 1]
            assert t["host_data_ranks"] == [rank % 2, rank % 2 + 2]


@pytest.mark.parametrize("how", ["no_model_axis", "indivisible",
                                 "cli_vmap_tp", "cli_vmap_mp2"])
def test_replica_tp_refusals_as_the_reference(runs, how):
    """The reference's refusals: ``replica_tp`` on a mesh with no
    ``model`` axis, a model axis that does not divide the world (before
    any process group is touched) and the mesh-only flags with
    ``--backend vmap``."""
    if how == "no_model_axis":
        for got in runs["world4_all"]:
            assert "needs a 'model' mesh axis" in \
                got["topology"]["refused_no_model"]
    elif how == "indivisible":
        with pytest.raises(ValueError, match="does not divide"):
            mesh_mod.make_host_mesh(3, device="cpu")
        assert not torch.distributed.is_initialized()
    else:
        flag = (["--placement", "replica_tp"] if how == "cli_vmap_tp"
                else ["--model-parallel", "2"])
        with pytest.raises(SystemExit):
            train.parse_args(flag)


def test_replica_axes_as_the_reference():
    assert mesh_mod.replica_axes_for("replica_ddp", False) == ("data",)
    assert mesh_mod.replica_axes_for("replica_dp", True) == ("pod", "data")
    assert mesh_mod.replica_axes_for("fsdp", True) == ("pod",)
    assert mesh_mod.replica_axes_for("fsdp", False) == ()


def test_bind_refuses_an_indivisible_R(runs):
    assert "not divisible by the mesh's 4 replica devices" in \
        runs["world4"]["topology"]["refused"]


def test_describe_and_chunks(runs):
    for rank, got in enumerate(runs["world4_all"]):
        t = got["topology"]
        assert t["describe"]["backend"] == "mesh"
        assert t["describe"]["n_devices"] == 4
        assert t["describe"]["mesh"] == {"data": 4, "model": 1}
        assert t["describe"]["placement"] == "replica_ddp"
        assert t["describe"]["model_parallel"] == 1
        assert t["describe"]["process_group"] == "gloo"
        assert t["describe"]["rank"] == rank
        assert t["replicas"] == [2 * rank, 2 * rank + 1]
        assert t["default_group_size"] is None
        # two nodes of two GPUs: a pod is a node, its replicas a group
        assert t["pods_shape"] == {"pod": 2, "data": 2, "model": 1}
        assert t["pods_group_size"] == 4
        # the reference's replica counts: every GPU a replica under
        # replica_ddp, one a pod under fsdp
        assert t["pods_replicas"] == {"replica_ddp": 4, "fsdp": 2}


# ----------------------------------------------------------------- world 1
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("use_kernel", [None, True], ids=["plain", "kernel"])
def test_world1_is_vmap_bitwise(runs, model, use_kernel):
    got = runs["world1"][f"{model}-{use_kernel}"]
    mesh, vmap = got["mesh"], got["vmap"]
    for k in ("sync_steps", "periods", "losses", "s_k", "n_syncs"):
        assert mesh[k] == vmap[k], k
    assert len(mesh["s_k"]) >= 4
    for a, b in zip(mesh["W"], vmap["W"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ worlds 2, 4
def _close(got, want, model):
    assert got["sync_steps"] == want["sync_steps"]
    assert got["periods"] == want["periods"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["s_k"], want["s_k"], rtol=1e-3,
                               atol=1e-5)
    lr = ranks.MODELS[model]["lr"]
    for a, b in zip(got["W"], want["W"]):
        if model == "cnn":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.05 * lr)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_matches_the_ports_vmap(runs, world, model):
    _close(runs[f"world{world}"][f"{model}-None"]["mesh"],
           runs[f"vmap-{model}"], model)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("world", [2, 4])
def test_mesh_matches_the_references_vmap(runs, world, model):
    _close(runs[f"world{world}"][f"{model}-None"]["mesh"],
           runs[f"jax-{model}"], model)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_keeps_the_same_history(runs, world):
    """The history's scalars are global: each rank holds them all."""
    per_rank = runs[f"world{world}_all"]
    for got in per_rank[1:]:
        for name, res in got.items():
            if name == "topology":
                continue
            for k in ("losses", "s_k", "sync_steps", "periods"):
                assert res["mesh"][k] == per_rank[0][name]["mesh"][k]
