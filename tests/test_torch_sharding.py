"""The port's sharding rules (``repro_torch/launch/sharding.py``) against
the reference's (``repro/launch/sharding.py``) on the CPU: the same spec
at every leaf, compared as tuples, for every config of
``available_configs()`` at model sizes 1, 2, 4 and 16, for the plans
``replica_dp``, ``fsdp`` and ``replica_ddp``, ``vocab_parallel_embed`` on
and off, stacked and unstacked, for the parameters, the adamw and
momentum states and the serving caches at batch 1 and 4.  The reference's
trees are abstract (``jax.eval_shape``) on an ``AbstractMesh``, built as
``tests/test_sharding.py`` builds one; the port's live on the meta
device.  Each rank's share of a replica (``backends/tp.py``'s ``Layout``)
is 1/m of every sharded leaf and the whole of every other.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs.base import ParallelismPlan as JaxPlan
from repro.launch import sharding as jsh
from repro.launch import specs as jsp
from repro.launch.mesh import replica_axes_for as jax_replica_axes_for
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.backends.tp import Layout
from repro_torch.configs import available_configs, get_config
from repro_torch.configs.base import ParallelismPlan
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import replica_axes_for
from repro_torch.models import model as M
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = list(available_configs())
MODEL_SIZES = (1, 2, 4, 16)
DATA = 4
PLANS = ("replica_dp", "fsdp", "replica_ddp")
R = 8


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(sizes, names)


def _ref_flat(spec_tree):
    """(path, spec tuple) of each leaf of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda s: isinstance(s, P))
    return [(jsh._path_str(p), tuple(s)) for p, s in flat]


@functools.lru_cache(maxsize=None)
def _ref_params(arch, stacked):
    if stacked:
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct((R,) + x.shape, x.dtype),
            _ref_params(arch, False))
    return jsp.abstract_params(jax_get_config(arch).model)


@functools.lru_cache(maxsize=None)
def _port_params(arch, stacked):
    if stacked:
        return tree_map(lambda x: torch.empty((R,) + tuple(x.shape),
                                              dtype=x.dtype, device="meta"),
                        _port_params(arch, False))
    return M.init_params(0, get_config(arch).model, device="meta")


@functools.lru_cache(maxsize=None)
def _ref_opt(arch, opt, stacked):
    return jsp.abstract_opt_state(jax_get_optimizer(opt),
                                  _ref_params(arch, stacked), stacked)


@functools.lru_cache(maxsize=None)
def _port_opt(arch, opt, stacked):
    return get_optimizer(opt).init(_port_params(arch, stacked),
                                   n_replicas=R if stacked else None)


@functools.lru_cache(maxsize=None)
def _specs(arch, m, plan, vocab, stacked):
    """The reference's and the port's spec trees, the abstract mesh, both
    plans and the replica axes."""
    mesh = _abstract_mesh((DATA, m), ("data", "model"))
    rep = jax_replica_axes_for(plan, False)
    jplan = JaxPlan(plan=plan, vocab_parallel_embed=vocab)
    ref = jsh.param_specs(jax_get_config(arch).model,
                          _ref_params(arch, stacked), mesh, jplan,
                          replica_axes=rep, stacked=stacked)
    tplan = ParallelismPlan(plan=plan, vocab_parallel_embed=vocab)
    got = sh.param_specs(get_config(arch).model, _port_params(arch, stacked),
                         {"data": DATA, "model": m}, tplan,
                         replica_axes=replica_axes_for(plan, False),
                         stacked=stacked)
    return ref, got, mesh, jplan, tplan, rep


@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, m):
    for plan in PLANS:
        for vocab in (True, False):
            for stacked in (True, False):
                ref, got, *_ = _specs(arch, m, plan, vocab, stacked)
                assert sh.flat_specs(got) == _ref_flat(ref), \
                    (plan, vocab, stacked)


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_the_references(arch, m, opt):
    for plan in ("replica_dp", "fsdp"):
        for stacked in (True, False):
            ref, got, mesh, jplan, tplan, rep = _specs(arch, m, plan, True,
                                                       stacked)
            jopt = _ref_opt(arch, opt, stacked)
            ref_o = jsh.opt_specs(jax_get_config(arch).model, jopt, ref,
                                  mesh, jplan, replica_axes=rep,
                                  stacked=stacked)
            topt = _port_opt(arch, opt, stacked)
            got_o = sh.opt_specs(get_config(arch).model, topt, got,
                                 {"data": DATA, "model": m}, tplan,
                                 replica_axes=rep, stacked=stacked)
            assert sh.flat_specs(got_o) == _ref_flat(ref_o), (plan, stacked)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, batch):
    S = 1024
    jcfg, tcfg = jax_get_config(arch).model, get_config(arch).model
    ref_c = jsp.abstract_caches(jcfg, batch, S)
    got_c = M.init_caches(tcfg, batch, S, device="meta")
    for m in MODEL_SIZES:
        mesh = _abstract_mesh((DATA, m), ("data", "model"))
        ref = jsh.cache_specs(jcfg, ref_c, mesh, batch=batch)
        got = sh.cache_specs(tcfg, got_c, {"data": DATA, "model": m},
                             batch=batch)
        assert sh.flat_specs(got) == _ref_flat(ref), m


def test_specs_name_the_model_axis_where_the_reference_does():
    """The heavy matrices shard over 'model' (Qwen2.5-14B, as the
    reference's ``test_big_tensors_are_sharded_qwen``)."""
    _, got, *_ = _specs("qwen2.5-14b", 16, "replica_dp", True, True)
    blk = got["blocks"][0]
    assert blk["attn"]["wq"]["w"] == ("data", None, "model")
    assert blk["attn"]["wo"]["w"] == ("data", "model", None)
    assert got["embed"] == ("data", "model", None)
    _, got, *_ = _specs("qwen2.5-14b", 16, "replica_dp", False, True)
    assert got["embed"] == ("data", None, "model")


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements((None, "model")) == [Shard(1)]
    assert sh.placements(("data", "model", None), stacked=True) == [Shard(0)]
    assert sh.placements(("data", None, None), stacked=True) == [Replicate()]
    assert sh.placements(()) == [Replicate()]


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_ranks_share_is_what_the_specs_imply(arch, m):
    """Every model rank's shard of a sharded leaf is 1/m of it and the
    shards tile it; a leaf the specs leave whole is held whole.  The
    ranks' bytes sum to the replica's bytes plus (m − 1) copies of the
    whole leaves."""
    _, specs, *_ = _specs(arch, m, "replica_dp", True, True)
    W = _port_params(arch, True)
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(W))
    rep = 0
    totals = []
    for index in range(m):
        lay = Layout(m, index)
        lay.record(specs)
        dims = lay.dims_of(W)
        local = [lay.cut(x, d) for x, d in zip(tree_leaves(W), dims)]
        for x, y, d in zip(tree_leaves(W), local, dims):
            if d is None:
                assert y.shape == x.shape
            else:
                assert y.shape[d] * m == x.shape[d]
                assert y.numel() * m == x.numel()
        assert lay.whole_shapes(tree_unflatten(W, local)) == \
            [tuple(x.shape) for x in tree_leaves(W)]
        if index == 0:
            rep = sum(x.numel() * x.element_size()
                      for x, d in zip(tree_leaves(W), dims) if d is None)
        totals.append(sum(y.numel() * y.element_size() for y in local))
    assert sum(totals) == whole + (m - 1) * rep
    assert len(set(totals)) == 1
