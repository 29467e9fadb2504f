"""The QSGD programs: the port against the reference on the same numpy
inputs and the same threefry keys.

Levels agree exactly wherever the two norms agree to the bit.  A norm is
an f32 sum over a whole leaf, which the two libraries take in different
orders, so it may differ in its last bit; a level then flips by ±1 only
where the uniform lies within that rounding of the element's fraction.
The tests allow one element in 10^4 to flip and count them: on these
inputs none flipped (0 of 79,968 levels per tree, and 0 of the QSGD
step's 4 x 393,216 gradient levels).  Values built from the levels
(dequantized values, the new W and anchor) agree to rtol 1e-5, plus one
quantum norm/s where a level flipped; S_k to rtol 1e-5.

The QSGD step's W agrees to atol 0.05·lr, the bound of the ADPSGD engine
test: where the levels of the replicas cancel, the mean gradient is a
difference of per-replica norms of the order of adamw's eps, and a
last-bit difference of a norm becomes a visible share of the step
(measured: 156 of 131,072 elements of one leaf differ by up to 3.46e-6
at lr 4e-3, all with identical levels)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import VmapBackend as JaxVmapBackend
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import averaging as jax_avg
from repro.core import qsgd as jax_qsgd
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.launch.steps import make_loss_fn as jax_make_loss_fn
from repro.models import model as jax_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.backends import VmapBackend
from repro_torch.configs import get_config, reduced
from repro_torch.core import averaging as torch_avg
from repro_torch.core import prng, qsgd
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import make_loss_fn
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves

R, B, SEQ = 4, 4, 32
LR = 4e-3
MAX_FLIP_SHARE = 1e-4
KEY = jax.random.fold_in(jax.random.PRNGKey(17), 3)


def _pair(key):
    return tuple(int(v) for v in np.asarray(key))


def _tree(rng):
    def a(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)
    return {"embed": a(512, 128), "final_norm": {},
            "blocks": [{"norm1": {}, "attn": {"wq": {"w": a(128, 64)}}},
                       {"mlp": {"w_up": {"w": a(64, 96)}, "b": a(96)}}]}


def _n_flips(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert np.abs(got - want).max(initial=0) <= 1
    return int((got != want).sum())


def _olmo():
    cfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=SEQ)
    params0 = jax_model.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree_util.tree_map(np.asarray, params0)


@pytest.mark.parametrize("bits", [4, 8])
def test_split_pytree_matches_reference(bits):
    tree = _tree(np.random.RandomState(bits))
    jl, jn = jax_qsgd.quantize_split_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree), KEY, bits)
    tl, tn = qsgd.quantize_split_pytree(params_from_numpy(tree, "cpu"),
                                        _pair(KEY), bits)
    flips, total = 0, 0
    for g, w in zip(tree_leaves(tl), jax.tree_util.tree_leaves(jl)):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        flips += _n_flips(g.numpy(), w)
        total += g.numel()
    assert flips <= MAX_FLIP_SHARE * total
    for g, w in zip(tree_leaves(tn), jax.tree_util.tree_leaves(jn)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    jdq = jax_qsgd.dequantize_split_pytree(jl, jn, bits)
    tdq = qsgd.dequantize_split_pytree(tl, tn, bits)
    fused = qsgd.quantize_pytree(params_from_numpy(tree, "cpu"), _pair(KEY),
                                 bits)
    s = (1 << (bits - 1)) - 1
    for g, f, w, nm in zip(tree_leaves(tdq), tree_leaves(fused),
                           jax.tree_util.tree_leaves(jdq),
                           tree_leaves(tn)):
        assert torch.equal(g, f)              # split + dequantize == fused
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=float(nm) / s if flips else 0)


def test_quantize_pytree_matches_reference():
    tree = _tree(np.random.RandomState(7))
    want = jax_qsgd.quantize_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree), KEY, 8)
    got = qsgd.quantize_pytree(params_from_numpy(tree, "cpu"), _pair(KEY), 8)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_plain_route_equals_wrapper_route_on_cpu():
    tree = params_from_numpy(_tree(np.random.RandomState(2)), "cpu")
    a = qsgd.quantize_split_pytree(tree, _pair(KEY), 8, use_kernel=True)
    b = qsgd.quantize_split_pytree(tree, _pair(KEY), 8, use_kernel=False)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_qsgd_step_matches_reference():
    """One QSGD step of reduced OLMo with adamw, R = 4."""
    cfg, params0 = _olmo()
    jdata = JaxTokens(cfg.vocab_size, SEQ, n_samples=R * B * 4, seed=0)
    batch = jdata.batches(n_replicas=R, per_replica_batch=B)(0)
    jopt = jax_get_optimizer("adamw")
    jW = jax_avg.stack_replicas(params0, R)
    jstep = jax_qsgd.make_qsgd_step(jax_make_loss_fn(cfg), jopt, 8)
    jW, _, jm = jstep(jW, jax.vmap(jopt.init)(jW), batch, jnp.float32(LR),
                      KEY)

    tcfg = reduced(get_config("olmo-1b").model, max_seq_len=SEQ)
    tdata = SyntheticTokens(tcfg.vocab_size, SEQ, n_samples=R * B * 4, seed=0)
    tbatch = tdata.batches(n_replicas=R, per_replica_batch=B,
                           device="cpu")(0)
    topt = get_optimizer("adamw")
    tW = torch_avg.stack_replicas(params_from_numpy(params0, "cpu"), R)
    tstep = VmapBackend(device="cpu").qsgd_step(make_loss_fn(tcfg), topt, 8)
    tW, _, tm = tstep(tW, topt.init(tW, n_replicas=R), tbatch, LR,
                      _pair(KEY))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert "grad_norm" not in tm and set(tm) == set(jm)
    got, want = tree_leaves(tW), jax.tree_util.tree_leaves(jW)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=0.05 * LR)
        assert all(torch.equal(g[r], g[0]) for r in range(R))


def test_quantized_all_mean_matches_reference():
    _, params0 = _olmo()
    rng = np.random.RandomState(5)
    W = jax.tree_util.tree_map(
        lambda p: (p[None] + 0.01 * rng.randn(R, *p.shape)).astype(
            np.float32), params0)
    anchor = jax.tree_util.tree_map(lambda w: w.mean(axis=0), W)
    jW, janchor, js = JaxVmapBackend().quantized_all_mean(8)(
        jax.tree_util.tree_map(jnp.asarray, W),
        jax.tree_util.tree_map(jnp.asarray, anchor), KEY)
    tanchor = params_from_numpy(anchor, "cpu")
    tW, tanchor2, ts = VmapBackend(device="cpu").quantized_all_mean(8)(
        params_from_numpy(W, "cpu"), tanchor, _pair(KEY))
    assert tanchor2 is tanchor                # the anchor moves in place
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    for g, w in zip(tree_leaves(tW), jax.tree_util.tree_leaves(jW)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
        assert all(torch.equal(g[r], g[0]) for r in range(R))
    for g, w in zip(tree_leaves(tanchor), jax.tree_util.tree_leaves(janchor)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_quantized_all_mean_plain_route_agrees():
    """use_kernel=False (the plain route, never the default) against the
    default route on the CPU: the same arithmetic, bit for bit."""
    rng = np.random.RandomState(6)
    W = {"a": rng.randn(R, 300).astype(np.float32), "n": {},
         "b": [rng.randn(R, 7, 5).astype(np.float32)]}
    anchor = {"a": W["a"].mean(0), "n": {}, "b": [W["b"][0].mean(0)]}
    outs = []
    for use_kernel in (None, False):
        backend = VmapBackend(use_kernel=use_kernel, device="cpu")
        outs.append(backend.quantized_all_mean(8)(
            params_from_numpy(W, "cpu"), params_from_numpy(anchor, "cpu"),
            _pair(KEY)))
    for x, y in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_quantize_with_given_norm_equals_quantize_alone(use_kernel):
    """``quantize(v, key, norm=...)`` with the norm of a grouped call is
    ``quantize(v, key)``, bit for bit, levels and norm."""
    rng = np.random.RandomState(8)
    vs = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in ((300,), (7, 5), (1,), (64, 33))]
    nms = qsgd.norms(vs)
    assert nms.shape == (len(vs),) and nms.dtype == torch.float32
    for i, (v, k) in enumerate(zip(vs, prng.split(_pair(KEY), len(vs)))):
        lv, nm = qsgd.quantize(v, k, 8, use_kernel=use_kernel, norm=nms[i])
        lv0, nm0 = qsgd.quantize(v, k, 8, use_kernel=use_kernel)
        assert torch.equal(lv, lv0) and torch.equal(nm, nm0)


def test_norms_match_reference_norms():
    """``norms`` of a group against the reference's per-tensor norm
    (``jnp.linalg.norm`` of the f32 tensor), rtol 1e-6; a bf16 tensor is
    taken in f32."""
    rng = np.random.RandomState(9)
    arrays = [rng.randn(*s).astype(np.float32)
              for s in ((4097,), (33, 17), (1,), (512, 128))]
    got = qsgd.norms([torch.from_numpy(a) for a in arrays])
    for g, a in zip(got, arrays):
        np.testing.assert_allclose(float(g), float(jnp.linalg.norm(a)),
                                   rtol=1e-6)
    b = torch.from_numpy(arrays[1]).to(torch.bfloat16)
    assert torch.equal(qsgd.norms([b])[0],
                       torch.sqrt(b.float().square().sum()))
