"""The port's mixture of experts (``models/layers.py``: ``init_moe``,
``moe_route``, ``moe_forward``) and ``model.py::active_param_count``
against the reference, on the CPU, from numpy inputs made from a seed.

The layer runs at the reduced configs' widths (4 experts, top 2, expert
width 64, d_model 128) on 2 x 128 tokens (one group of 256), with and
without shared experts, at the config's capacity factor of 1.25 (C = 160:
routing of random inputs is balanced enough that nothing is dropped) and
at 0.5 (C = 64, which forces drops, asserted), and with ties forced by
equal router columns (the lower expert index must win, as
``jax.lax.top_k`` breaks ties).

Tolerances: the init within three f32 ulps (rtol 5e-7), the bound of
``prng.normal`` (``test_torch_model.py``).  In f32 the output within rtol
1e-5, atol 1e-6, and the aux losses within rtol 1e-5 (f32 sums in another
order); gradients rtol 1e-4 and atol 1e-6 of the leaf's largest
magnitude (each gradient sums 256 tokens' terms, through the experts,
the router and the aux losses, in another order, so an element near zero
carries the f32 rounding of its large terms: measured up to 3.4e-6 on
leaves reaching 15).  In bf16
each of the three expert products and the SwiGLU's silu round to bf16,
and the two libraries round silu differently (``jax.nn.silu`` and
``F.silu`` agree on 63 % of random bf16 inputs), so an output element may
land an ulp or two from the reference's (about 60 % of them differ at
all): the output is held to two bf16 ulps of its largest magnitude
(atol 2^-6 · max |out|); the aux losses, computed in f32 from the same
bf16 input, within rtol 1e-5.  The f32 cases hold the algorithm itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as torch_model
from repro_torch.tree import tree_leaves

ARCHS = ["mixtral-8x22b", "deepseek-v2-lite-16b"]
B, S = 2, 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", cf=None):
    """(reference, port) reduced configs, compute in ``dtype``, at capacity
    factor ``cf`` (the config's when None)."""
    out = []
    for get, red in ((jax_get_config, jax_reduced), (get_config, reduced)):
        cfg = red(get(arch).model, max_seq_len=S, compute_dtype=dtype)
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


def _moe_params(jcfg, seed=0, tie=False):
    p = jax.tree_util.tree_map(np.asarray, jax_layers.init_moe(
        jax.random.PRNGKey(seed), jcfg))
    if tie:       # experts 0 and 1, and 2 and 3, score alike for every token
        p["router"] = p["router"].copy()
        p["router"][:, 1] = p["router"][:, 0]
        p["router"][:, 3] = p["router"][:, 2]
    return p


def _x(jcfg, seed=1):
    x = np.random.RandomState(seed).randn(B, S, jcfg.d_model)
    return x.astype(np.float32)


def _run_both(arch, dtype, cf, tie, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype, cf)
    p = _moe_params(jcfg, seed, tie)
    x = _x(jcfg)
    jdt = jnp.dtype(dtype)
    out_j, aux_j = jax.jit(lambda p, x: jax_layers.moe_forward(
        p, x, jcfg))(p, jnp.asarray(x).astype(jdt))
    tp = params_from_numpy(p, "cpu")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        out_t, aux_t = L.moe_forward(tp, xt, tcfg)
        route = L.moe_route(tp, xt, tcfg)
    return (np.asarray(out_j.astype(jnp.float32)), aux_j,
            out_t.float().numpy(), aux_t, route, tcfg)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_reference(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    want = jax_layers.init_moe(jax.random.PRNGKey(seed), jcfg)
    got = L.init_moe(prng.prng_key(seed), tcfg, device="cpu")
    assert jax.tree_util.tree_structure(params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    assert ("shared" in got) == bool(tcfg.moe.n_shared_experts)
    assert got["router"].dtype == torch.float32
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)


CASES = [("no_drops", 1.25, False), ("drops", 0.5, False),
         ("ties", None, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,cf,tie", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, case, cf, tie, dtype):
    out_j, aux_j, out_t, aux_t, route, tcfg = _run_both(arch, dtype, cf, tie)
    T, k = B * S, tcfg.moe.top_k
    dropped = T * k - int(route["keep"].sum())
    assert route["G"] * route["Sg"] == T
    if case == "drops":
        assert route["C"] == 64 and dropped > 0
    elif case == "no_drops":
        assert route["C"] == 160 and dropped == 0
    else:     # every token's two picks are a tied pair, the lower one first
        idx = route["gate_idx"]
        assert bool((idx[..., 0] % 2 == 0).all())
        assert bool((idx[..., 1] == idx[..., 0] + 1).all())
    if dtype == "float32":
        np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(out_t, out_j, rtol=0,
                                   atol=2.0 ** -6 * np.abs(out_j).max())
    assert set(aux_t) == set(aux_j) == {"moe_load_balance", "moe_z_loss"}
    for name in aux_j:
        np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("case,cf", [("no_drops", 1.25), ("drops", 0.5)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_reference(arch, case, cf):
    """d/d(x, router, experts, shared) of sum(out · g) + both aux losses,
    against ``jax.grad``, in f32."""
    jcfg, tcfg = _cfgs(arch, "float32", cf)
    p, x = _moe_params(jcfg), _x(jcfg)
    g = np.random.RandomState(2).randn(B, S, jcfg.d_model).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_layers.moe_forward(p, x, jcfg)
        return jnp.sum(out * g) + sum(aux.values())

    gp_j, gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = params_from_numpy(p, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = L.moe_forward(tp, xt, tcfg)
    loss = (out * torch.from_numpy(g)).sum() + sum(aux.values())
    grads = torch.autograd.grad(loss, [xt] + leaves)
    want = [gx_j] + jax.tree_util.tree_leaves(gp_j)
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(params, "cpu")
    want = jax_model.active_param_count(jcfg, params)
    assert torch_model.active_param_count(tcfg, tp) == want
    assert want < torch_model.param_count(tp)


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek-v2-lite-16b", 15_706_484_224, 2_661_150_208),
    ("mixtral-8x22b", 140_630_071_296, 39_161_468_928)])
def test_active_param_count_at_full_size(arch, total, active):
    """The published configs' counts, from the reference's parameter
    shapes (``jax.eval_shape``; nothing is allocated: the port's counts
    read only each leaf's size, here of a meta tensor)."""
    shapes = jax.eval_shape(lambda k: jax_model.init_params(
        k, jax_get_config(arch).model), jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    cfg = get_config(arch).model
    assert torch_model.param_count(meta) == total
    assert torch_model.active_param_count(cfg, meta) == active
    assert jax_model.active_param_count(jax_get_config(arch).model,
                                        shapes) == active
