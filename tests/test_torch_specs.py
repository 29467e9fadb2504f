"""The dry run's inputs: ``InputShape`` and the config predicates
(``configs/base.py``) and ``launch/specs.py``, the port against the
reference for every config.  The batch specs: the same shapes, dtypes and
partition specs (the reference's ``PartitionSpec`` as a tuple) for every
arch x shape x plan on the 32 x 8 and 2 x 32 x 8 meshes; the abstract
parameter, optimizer-state and cache trees: the shapes and dtypes of
``jax.eval_shape``'s, leaf for leaf."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import specs as jax_specs
from repro.launch.mesh import n_replicas_for as jax_n_replicas_for
from repro.launch.mesh import replica_axes_for as jax_replica_axes_for
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.configs import (INPUT_SHAPES, InputShape, available_configs,
                                 get_config, reduced)
from repro_torch.launch import specs
from repro_torch.launch.mesh import n_replicas_for, replica_axes_for
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves

ARCHS = available_configs()
PLANS = ("replica_dp", "fsdp", "replica_ddp")
MESHES = {False: {"data": 32, "model": 8},
          True: {"pod": 2, "data": 32, "model": 8}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the host's cores: torch's thread pool
    would spin against the others' and slow these small steps tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(shape):
    """What the reference's specs read of a mesh: its axis names and the
    shape of its device array."""
    return types.SimpleNamespace(axis_names=tuple(shape),
                                 devices=np.empty(tuple(shape.values())))


def _sig(tree, leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves(tree)]


def _spec_tree(specs_):
    return {k: tuple(v) for k, v in specs_.items()}


def test_input_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            JAX_SHAPES[name])
    assert dataclasses.astuple(InputShape()) == dataclasses.astuple(
        type(JAX_SHAPES["train_4k"])())


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_predicates_are_the_references(arch, small):
    cfg, ref = get_config(arch).model, jax_get_config(arch).model
    if small:
        cfg, ref = reduced(cfg), jax_reduced(ref)
    variants = [(cfg, ref)]
    # a scanned depth (the reduced variants do not scan)
    variants.append((dataclasses.replace(cfg, scan_layers=True),
                     dataclasses.replace(ref, scan_layers=True)))
    for c, r in variants:
        assert c.scan_grouping() == r.scan_grouping()
        assert c.is_subquadratic() == r.is_subquadratic()
        assert c.has_decoder() == r.has_decoder()


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_are_the_references(arch, plan, multi_pod):
    cfg, ref = get_config(arch).model, jax_get_config(arch).model
    shape = MESHES[multi_pod]
    jmesh = _jax_mesh(shape)
    axes = replica_axes_for(plan, multi_pod)
    assert axes == jax_replica_axes_for(plan, multi_pod)
    R = n_replicas_for(types.SimpleNamespace(shape=shape), plan, multi_pod)
    assert R == jax_n_replicas_for(jmesh, plan, multi_pod)
    for name, s in INPUT_SHAPES.items():
        js = JAX_SHAPES[name]
        got = specs.train_batch_specs(cfg, s, R, plan, replica_axes=axes)
        want = jax_specs.train_batch_specs(ref, js, R, plan,
                                           replica_axes=axes)
        assert _sig(got[0], tree_leaves) == _sig(
            want[0], jax.tree_util.tree_leaves)
        assert got[1] == _spec_tree(want[1])
        for fn in ("prefill_batch_specs", "decode_batch_specs"):
            got = getattr(specs, fn)(cfg, s, shape)
            want = getattr(jax_specs, fn)(ref, js, jmesh)
            assert _sig(got[0], tree_leaves) == _sig(
                want[0], jax.tree_util.tree_leaves), fn
            assert got[1] == _spec_tree(want[1]), fn


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_are_eval_shapes(arch):
    """Full-size configs: the init on the meta device against
    ``jax.eval_shape`` of the reference's, stacked over 2 replicas and not
    (the optimizer state of the stacked tree as ``vmap(opt.init)``), and
    the bf16 caches of a 2 x 64 decode."""
    run, ref_run = get_config(arch), jax_get_config(arch)
    cfg, ref = run.model, ref_run.model
    for n in (0, 2):
        got = specs.abstract_params(cfg, n_replicas=n)
        want = jax_specs.abstract_params(ref, n_replicas=n)
        assert _sig(got, tree_leaves) == _sig(want, jax.tree_util.tree_leaves)
        assert all(x.device.type == "meta" for x in tree_leaves(got))
        if n:
            opt = specs.abstract_opt_state(get_optimizer(run.optimizer),
                                           got, stacked=True)
            jopt = jax_specs.abstract_opt_state(
                jax_get_optimizer(ref_run.optimizer), want, stacked=True)
            assert _sig(opt, tree_leaves) == _sig(
                jopt, jax.tree_util.tree_leaves)
    got = specs.abstract_caches(cfg, 2, 64)
    want = jax_specs.abstract_caches(ref, 2, 64)
    assert _sig(got, tree_leaves) == _sig(want, jax.tree_util.tree_leaves)
