"""The port's Mamba block (``models/mamba.py``) against the reference's, on
the CPU, at the reduced Jamba widths (d_model 128, d_inner 256, d_state
16, d_conv 4, dt_rank 8).

Tolerances: the scan bit for bit against ``jax.lax.associative_scan`` run
op by op (the same recursion, the same products and sums in the same
order), and within rtol = atol = 2e-6 of it under ``jax.jit``, where XLA
contracts ``g2 * u1 + u2`` into a fused multiply-add (measured: at most
7.2e-7 at length 100); the init within three f32 ulps (rtol 5e-7,
``prng.normal``'s bound); the block's output over a full sequence and at
each decode step, and the decode state, in f32 within rtol = atol = 1e-5
(f32 sums in another order, as ``test_torch_model.py``).  In bf16 the
reference's and the port's roundings differ (XLA's CPU matmuls and
fusions against torch's kernels): the output is bf16 as there, and lies
within a mean of 2^-6 and a max of 2^-3 of the output's scale of the
reference's (measured: 0.6 % and 0.9 %); ``dt`` is the softplus's bf16
result, so every value is a bf16 value, on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.interop import params_from_numpy
from repro_torch.models import mamba as M

ARCH = "jamba-1.5-large-398b"
B, S = 2, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return [dataclasses.replace(red(get(ARCH).model, max_seq_len=32), **kw)
            for get, red in ((jax_get_config, jax_reduced),
                             (get_config, reduced))]


def _inputs(jcfg, seed=0, S=S):
    p = jax.tree_util.tree_map(np.asarray, jax_mamba.init_mamba(
        jax.random.PRNGKey(seed), jcfg))
    x = np.random.RandomState(seed + 1).randn(B, S, jcfg.d_model)
    return p, x.astype(np.float32)


def _scan_inputs(n):
    rs = np.random.RandomState(n)
    g = rs.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    u = rs.randn(2, n, 3, 4).astype(np.float32)
    return g, u


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100])
def test_scan_matches_associative_scan(n):
    g, u = _scan_inputs(n)
    eager = jax.lax.associative_scan(jax_mamba._scan_combine,
                                     (jnp.asarray(g), jnp.asarray(u)), axis=1)
    jitted = jax.jit(lambda g, u: jax.lax.associative_scan(
        jax_mamba._scan_combine, (g, u), axis=1))(g, u)
    got = M.associative_scan(torch.from_numpy(g), torch.from_numpy(u))
    for t, e, j in zip(got, eager, jitted):
        assert t.shape == e.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(e))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6,
                                   atol=2e-6)


def test_scan_is_the_recurrence():
    """h_t = g_t h_{t-1} + u_t from h = 0, step by step."""
    g, u = _scan_inputs(100)
    _, h = M.associative_scan(torch.from_numpy(g), torch.from_numpy(u))
    want, acc = np.zeros_like(u), np.zeros_like(u[:, 0])
    for t in range(u.shape[1]):
        acc = g[:, t] * acc + u[:, t]
        want[:, t] = acc
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_mamba_matches_reference(seed):
    jcfg, tcfg = _cfgs()
    want = jax_mamba.init_mamba(jax.random.PRNGKey(seed), jcfg)
    got = M.init_mamba(prng.prng_key(seed), tcfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=5e-7, atol=0, err_msg=k)


def test_init_mamba_keeps_A_log_and_D_in_f32():
    jcfg, tcfg = _cfgs(param_dtype="bfloat16")
    want = jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    got = M.init_mamba(prng.prng_key(0), tcfg, device="cpu")
    for k in want:
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
    assert got["A_log"].dtype == got["D"].dtype == torch.float32
    assert got["in_proj"].dtype == torch.bfloat16


def test_init_mamba_state():
    jcfg, tcfg = _cfgs()
    want = jax_mamba.init_mamba_state(jcfg, B)
    got = M.init_mamba_state(tcfg, B, device="cpu")
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32 and not got[k].any()


def test_mamba_full_sequence_matches_reference():
    jcfg, tcfg = _cfgs()
    p, x = _inputs(jcfg)
    want, st = jax.jit(lambda p, x: jax_mamba.mamba_forward(p, x, jcfg))(p, x)
    with torch.no_grad():
        got, tst = M.mamba_forward(params_from_numpy(p, "cpu"),
                                   torch.from_numpy(x), tcfg)
    assert st is None and tst is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mamba_decode_matches_reference():
    """Every decode step from the zero state against the reference's: the
    output and both parts of the new state; the steps together against
    the port's own full sequence."""
    jcfg, tcfg = _cfgs()
    p, x = _inputs(jcfg, seed=2)
    tp = params_from_numpy(p, "cpu")
    jst = jax_mamba.init_mamba_state(jcfg, B)
    tst = M.init_mamba_state(tcfg, B, device="cpu")
    step = jax.jit(lambda p, x, s: jax_mamba.mamba_forward(p, x, jcfg,
                                                           state=s))
    outs = []
    for t in range(S):
        yj, jst = step(p, x[:, t:t + 1], jst)
        old, kept = tst, {k: v.clone() for k, v in tst.items()}
        with torch.no_grad():
            yt, tst = M.mamba_forward(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcfg, state=tst)
        # a new state, the old one left as it was
        assert all(tst[k] is not old[k] and torch.equal(old[k], kept[k])
                   for k in tst)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
        for k in jst:
            assert tst[k].dtype == torch.float32
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} step {t}")
        outs.append(yt)
    with torch.no_grad():
        full, _ = M.mamba_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mamba_bf16_matches_reference():
    jcfg, tcfg = _cfgs()
    p, x = _inputs(jcfg, seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = jax.jit(lambda p, x: jax_mamba.mamba_forward(p, x, jcfg))(p, xb)
    tp = params_from_numpy(p, "cpu")
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    u = np.random.RandomState(5).randn(B, S, M.d_inner(tcfg))
    ub = jnp.asarray(u, jnp.float32).astype(jnp.bfloat16)
    with torch.no_grad():
        got, _ = M.mamba_forward(tp, xt, tcfg)
        dt, _, _ = M._ssm_params(
            tp, torch.from_numpy(np.array(ub.astype(jnp.float32))).bfloat16(),
            tcfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    d = np.abs(got.float().numpy() - want)
    assert d.mean() <= 2 ** -6 * np.abs(want).mean()
    assert d.max() <= 2 ** -3 * np.abs(want).max()
    jdt, _, _ = jax_mamba._ssm_params(p, ub, jcfg)
    for t in (dt, torch.from_numpy(np.array(jdt))):
        assert t.dtype == torch.float32
        assert torch.equal(t.bfloat16().float(), t)


def test_mamba_grads_match_reference():
    jcfg, tcfg = _cfgs()
    p, x = _inputs(jcfg, seed=4)

    def jloss(p, x):
        y, _ = jax_mamba.mamba_forward(p, x, jcfg)
        return (y ** 2).mean()
    gj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(p, "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = M.mamba_forward(tp, xt, tcfg)
    loss = (y ** 2).mean()
    keys = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in keys] + [xt])
    for k, g in zip(keys + ["x"], grads):
        want = np.asarray(gxj if k == "x" else gj[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
