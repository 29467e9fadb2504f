"""Optimizer updates and the replica sync: the port against the reference
on the same numpy inputs (f32, rtol 1e-5: the same operations, rounded by
two libraries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import averaging as jax_avg
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.core import averaging as torch_avg
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(rng, lead=()):
    """A nested tree with the shapes of a small model, empty norm included."""
    def a(*shape):
        return rng.randn(*lead, *shape).astype(np.float32)
    return {"embed": a(16, 8), "final_norm": {},
            "blocks": [{"norm1": {}, "attn": {"wq": {"w": a(8, 8)}}},
                       {"norm1": {}, "mlp": {"w_up": {"w": a(8, 12)},
                                             "b": a(12)}}]}


def _assert_trees_close(got, want, **tol):
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("name", ["adamw", "momentum", "sgd"])
def test_optimizer_updates_match(name):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jopt, topt = jax_get_optimizer(name), get_optimizer(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for g in grads:         # three updates: adamw's bias correction moves
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             4e-3)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp, 4e-3)
    _assert_trees_close(tp, jp, **TOL)
    _assert_trees_close(ts, js, **TOL)


def test_adamw_state_is_per_replica():
    W = params_from_numpy(_tree(np.random.RandomState(1), lead=(3,)), "cpu")
    state = get_optimizer("adamw").init(W, n_replicas=3)
    assert state["t"].shape == (3,) and state["t"].dtype == torch.int32
    want = jax.vmap(jax_get_optimizer("adamw").init)(
        jax.tree_util.tree_map(jnp.asarray,
                               _tree(np.random.RandomState(1), lead=(3,))))
    assert [tuple(x.shape) for x in tree_leaves(state)] == \
        [x.shape for x in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("sync_momentum", [False, True])
def test_sync_replicas_matches(use_kernel, sync_momentum):
    rng = np.random.RandomState(2)
    R = 4
    W = _tree(rng, lead=(R,))
    opt = {"m": _tree(rng, lead=(R,))}
    jW, jopt, jsk = jax_avg.sync_replicas(
        jax.tree_util.tree_map(jnp.asarray, W),
        jax.tree_util.tree_map(jnp.asarray, opt),
        sync_momentum=sync_momentum, use_kernel=use_kernel)
    tW, topt, tsk = torch_avg.sync_replicas(
        params_from_numpy(W, "cpu"), params_from_numpy(opt, "cpu"),
        sync_momentum=sync_momentum, use_kernel=use_kernel)
    np.testing.assert_allclose(float(tsk), float(jsk), rtol=1e-5)
    _assert_trees_close(tW, jW, **TOL)
    _assert_trees_close(topt, jopt, **TOL)
    # every replica holds the mean afterwards
    for x in tree_leaves(tW):
        assert torch.equal(x, x[:1].expand_as(x))
    assert params_to_numpy(tW)["final_norm"] == {}


def test_probe_matches_parameter_variance():
    W = _tree(np.random.RandomState(3), lead=(4,))
    want = float(jax_avg.parameter_variance(
        jax.tree_util.tree_map(jnp.asarray, W)))
    got = float(torch_avg.parameter_variance(params_from_numpy(W, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, _, s_k = torch_avg.sync_replicas(params_from_numpy(W, "cpu"))
    np.testing.assert_allclose(float(s_k), want, rtol=1e-5)


def _jax_mse(p, batch):
    err = batch["x"] @ p["w"] + p["b"]["v"][None] - batch["y"]
    loss = jnp.mean(err * err)
    return loss, {"mse": loss}


def _torch_mse(p, batch):
    err = batch["x"] @ p["w"] + p["b"]["v"][None] - batch["y"]
    loss = (err * err).mean()
    return loss, {"mse": loss}


@pytest.mark.parametrize("kind", ["make_local_step", "make_full_step"])
@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_step_programs_match(kind, opt):
    rng = np.random.RandomState(4)
    R = 3
    W = {"w": rng.randn(R, 5, 3), "b": {"v": rng.randn(R, 3)}, "norm": {}}
    batch = {"x": rng.randn(R, 4, 5), "y": rng.randn(R, 4, 3)}
    W, batch = (jax.tree_util.tree_map(lambda a: a.astype(np.float32), t)
                for t in (W, batch))
    jopt = jax_get_optimizer(opt)
    jW = jax.tree_util.tree_map(jnp.asarray, W)
    jstate = jax.vmap(jopt.init)(jW)
    jstep = jax.jit(getattr(jax_avg, kind)(_jax_mse, jopt))
    topt = get_optimizer(opt)
    tW = params_from_numpy(W, "cpu")
    tstate = topt.init(tW, n_replicas=R)
    tstep = getattr(torch_avg, kind)(_torch_mse, topt)
    tbatch = params_from_numpy(batch, "cpu")
    for lr in (1e-2, 5e-3):
        jW, jstate, jm = jstep(jW, jstate, batch, lr)
        tW, tstate, tm = tstep(tW, tstate, tbatch, lr)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    _assert_trees_close(tW, jW, **TOL)
    _assert_trees_close(tstate, jstate, **TOL)


def test_opt_mean_program_matches():
    from repro.core.averaging import sync_opt_state as jax_sync_opt_state
    from repro_torch.backends import VmapBackend
    from repro_torch.backends.ops import opt_mean_op
    state = {"m": _tree(np.random.RandomState(5), lead=(4,)),
             "t": np.array([3, 3, 3, 3], np.int32)}
    want = jax_sync_opt_state(jax.tree_util.tree_map(jnp.asarray, state))
    got = VmapBackend(device="cpu").lower(opt_mean_op())(
        params_from_numpy(state, "cpu"))
    _assert_trees_close(got, want, **TOL)
    assert got["t"].dtype == torch.int32
