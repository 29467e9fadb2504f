"""The port's xLSTM blocks (``models/xlstm.py``: the mLSTM in its
chunkwise and step forms, the sLSTM recurrence, their states and the
per-head group norm) against the reference's, on the CPU, at the reduced
xLSTM widths (d_model 128, 4 heads: the mLSTM's heads 64 wide over its
2 x 128 inner width, the sLSTM's 32; the sLSTM's feed-forward 128 wide).

Tolerances: the init within three f32 ulps (rtol 5e-7, ``prng.normal``'s
bound); each block's output over a full sequence and at each decode step,
the decode state, and the chunkwise mLSTM over several chunks, in f32
within rtol = atol = 1e-5 (f32 sums in another order and cumulative
sums, as ``test_torch_model.py``; measured at most 3e-6); gradients rtol
1e-4 and atol 1e-6 of the leaf's largest magnitude.  ``CHUNK`` is set to
16 on both sides for the several-chunk cases (the reference is traced
afresh under ``jax.jit``, so no cached trace keeps 256).  In bf16 the
reference's and the port's roundings differ (XLA's CPU matmuls and
fusions against torch's kernels): the output is bf16 as there, and lies
within a mean of 2^-6 and a max of 2^-3 of the output's scale of the
reference's (measured: at most 1.0 % and 2.1 %); the decode state stays
f32 and h is bf16, as there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.interop import params_from_numpy
from repro_torch.models import xlstm as X

ARCH = "xlstm-350m"
B, S = 2, 12
BLOCKS = {  # kind -> (reference init, forward, state; port's)
    "mlstm": ((jax_xlstm.init_mlstm, jax_xlstm.mlstm_forward,
               jax_xlstm.init_mlstm_state),
              (X.init_mlstm, X.mlstm_forward, X.init_mlstm_state)),
    "slstm": ((jax_xlstm.init_slstm, jax_xlstm.slstm_forward,
               jax_xlstm.init_slstm_state),
              (X.init_slstm, X.slstm_forward, X.init_slstm_state)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return [red(get(ARCH).model, max_seq_len=64)
            for get, red in ((jax_get_config, jax_reduced),
                             (get_config, reduced))]


def _inputs(kind, jcfg, seed=0, S=S):
    p = jax.tree_util.tree_map(np.asarray, BLOCKS[kind][0][0](
        jax.random.PRNGKey(seed), jcfg))
    x = np.random.RandomState(seed + 1).randn(B, S, jcfg.d_model)
    return p, x.astype(np.float32)


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_init_matches_reference(kind, seed):
    jcfg, tcfg = _cfgs()
    want = BLOCKS[kind][0][0](jax.random.PRNGKey(seed), jcfg)
    got = BLOCKS[kind][1][0](prng.prng_key(seed), tcfg, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=5e-7, atol=0, err_msg=k)


def test_init_biases_and_widths():
    """b_f = 3 (mLSTM), the sLSTM bias in [0, 3, 0, 0] blocks, and its
    feed-forward int(D·4/3/64)·64 wide: 128 here, 1344 at d_model 1024."""
    _, tcfg = _cfgs()
    m = X.init_mlstm(prng.prng_key(0), tcfg, device="cpu")
    assert torch.equal(m["b_f"], torch.full((4,), 3.0))
    assert not m["b_i"].any()
    s = X.init_slstm(prng.prng_key(0), tcfg, device="cpu")
    D = tcfg.d_model
    assert torch.equal(s["b"], torch.cat([torch.zeros(D), torch.full((D,), 3.0),
                                          torch.zeros(2 * D)]))
    assert s["ff_up"].shape == (D, 128)
    full = dataclasses.replace(tcfg, d_model=1024)
    assert X.init_slstm(prng.prng_key(0), full, device="meta")[
        "ff_up"].shape == (1024, 1344)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_state_matches_reference(kind):
    jcfg, tcfg = _cfgs()
    want = BLOCKS[kind][0][2](jcfg, B)
    got = BLOCKS[kind][1][2](tcfg, B, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["m"].max() == torch.tensor(-1e30, dtype=torch.float32)


def test_group_norm_matches_reference():
    x = np.random.RandomState(0).randn(B, S, 4, 32).astype(np.float32) * 3
    scale = np.random.RandomState(1).randn(128).astype(np.float32)
    want = jax_xlstm._group_norm(jnp.asarray(x), jnp.asarray(scale))
    got = X._group_norm(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.shape == (B, S, 128)
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_full_sequence_matches_reference(kind):
    jcfg, tcfg = _cfgs()
    p, x = _inputs(kind, jcfg)
    fwd_j, fwd_t = BLOCKS[kind][0][1], BLOCKS[kind][1][1]
    want, st = jax.jit(lambda p, x: fwd_j(p, x, jcfg))(p, x)
    with torch.no_grad():
        got, tst = fwd_t(params_from_numpy(p, "cpu"), torch.from_numpy(x), tcfg)
    assert st is None and tst is None
    _close(got, want)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_decode_matches_reference(kind):
    """Every decode step from the initial state against the reference's:
    the output and every part of the new state (a new state, the old one
    left as it was); the steps together against the port's own full
    sequence."""
    jcfg, tcfg = _cfgs()
    p, x = _inputs(kind, jcfg, seed=2)
    tp = params_from_numpy(p, "cpu")
    (_, fwd_j, state_j), (_, fwd_t, state_t) = BLOCKS[kind]
    jst, tst = state_j(jcfg, B), state_t(tcfg, B, device="cpu")
    step = jax.jit(lambda p, x, s: fwd_j(p, x, jcfg, state=s))
    outs = []
    for t in range(S):
        yj, jst = step(p, x[:, t:t + 1], jst)
        old, kept = tst, {k: v.clone() for k, v in tst.items()}
        with torch.no_grad():
            yt, tst = fwd_t(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                            state=tst)
        assert all(tst[k] is not old[k] and torch.equal(old[k], kept[k])
                   for k in tst)
        _close(yt, yj, msg=f"step {t}")
        assert sorted(tst) == sorted(jst)
        for k in jst:
            assert tst[k].dtype == torch.float32
            _close(tst[k], jst[k], msg=f"{k} step {t}")
        outs.append(yt)
    with torch.no_grad():
        full, _ = fwd_t(tp, torch.from_numpy(x), tcfg)
    _close(torch.cat(outs, 1), full)


@pytest.mark.parametrize("S_", [64, 24])
def test_mlstm_chunkwise_over_several_chunks(monkeypatch, S_):
    """CHUNK = 16 on both sides: 4 chunks of 16 at S = 64; at S = 24, 16
    does not divide 24, so 3 chunks of 8.  The mLSTM block over them, and
    the chunkwise core against one chunk of the whole sequence."""
    jcfg, tcfg = _cfgs()
    p, x = _inputs("mlstm", jcfg, seed=3, S=S_)
    with torch.no_grad():
        one_chunk, _ = X.mlstm_forward(params_from_numpy(p, "cpu"),
                                       torch.from_numpy(x), tcfg)
    monkeypatch.setattr(jax_xlstm, "CHUNK", 16)
    monkeypatch.setattr(X, "CHUNK", 16)
    want, _ = jax.jit(lambda p, x: jax_xlstm.mlstm_forward(p, x, jcfg))(p, x)
    with torch.no_grad():
        got, _ = X.mlstm_forward(params_from_numpy(p, "cpu"),
                                 torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(got, one_chunk.numpy())
    rs = np.random.RandomState(4)
    H, dh = 4, 16
    q, k, v = (rs.randn(B, S_, H, dh).astype(np.float32) for _ in range(3))
    li = rs.randn(B, S_, H).astype(np.float32)
    lf = -np.abs(rs.randn(B, S_, H)).astype(np.float32)
    want = jax.jit(jax_xlstm._mlstm_chunkwise)(q, k, v, li, lf)
    got = X._mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, li, lf)))
    _close(got, want)
    # the reference ran the patched CHUNK: its scan is over S / L chunks
    jaxpr = jax.make_jaxpr(jax_xlstm._mlstm_chunkwise)(q, k, v, li, lf)
    scans = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "scan"]
    assert [e.params["length"] for e in scans] == [S_ // (16 if S_ % 16 == 0
                                                          else 8)]


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_bf16_matches_reference(kind):
    jcfg, tcfg = _cfgs()
    p, x = _inputs(kind, jcfg, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    fwd_j, fwd_t = BLOCKS[kind][0][1], BLOCKS[kind][1][1]
    want, _ = jax.jit(lambda p, x: fwd_j(p, x, jcfg))(p, xb)
    tp = params_from_numpy(p, "cpu")
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got, _ = fwd_t(tp, xt, tcfg)
        yt, st = fwd_t(tp, xt[:, :1], tcfg,
                       state=BLOCKS[kind][1][2](tcfg, B, device="cpu"))
    yj, jst = jax.jit(lambda p, x, s: fwd_j(p, x, jcfg, state=s))(
        p, xb[:, :1], BLOCKS[kind][0][2](jcfg, B))
    assert got.dtype == yt.dtype == torch.bfloat16
    assert want.dtype == yj.dtype == jnp.bfloat16
    assert all(st[k].dtype == torch.float32 for k in st)
    assert all(jst[k].dtype == jnp.float32 for k in jst)
    for g, w in ((got, want), (yt, yj)):
        w = np.asarray(w.astype(jnp.float32))
        d = np.abs(g.float().numpy() - w)
        assert d.mean() <= 2 ** -6 * np.abs(w).mean()
        assert d.max() <= 2 ** -3 * np.abs(w).max()


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_grads_match_reference(kind):
    jcfg, tcfg = _cfgs()
    p, x = _inputs(kind, jcfg, seed=6)
    fwd_j, fwd_t = BLOCKS[kind][0][1], BLOCKS[kind][1][1]

    def jloss(p, x):
        y, _ = fwd_j(p, x, jcfg)
        return (y ** 2).mean()
    gj, gxj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(p, "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = fwd_t(tp, xt, tcfg)
    keys = sorted(tp)
    grads = torch.autograd.grad((y ** 2).mean(), [tp[k] for k in keys] + [xt])
    for k, g in zip(keys + ["x"], grads):
        want = np.asarray(gxj if k == "x" else gj[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)
