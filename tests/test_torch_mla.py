"""The port's multi-head latent attention (``models/layers.py``: MLA's
``init_attention`` branch, ``init_kv_cache``'s latent cache,
``_mla_forward``, ``_rms``) against the reference's, on the CPU, at the
reduced DeepSeek-V2-Lite widths (4 heads, kv_lora_rank 64, rope 16, nope
32, v 32), with ``q_lora_rank`` 0 (V2-Lite's direct q projection) and 32
(the low-rank q path with its norm), in f32.

Tolerances: the init within three f32 ulps (rtol 5e-7,
``prng.normal``'s bound); the attention output over a full sequence and
each decode step within rtol = atol = 1e-5 (f32 sums in another order, as
``test_torch_model.py``); the caches within the same (they hold the
normalised latent and the rotated rope key the two computations write).
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

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(q_lora):
    out = []
    for get, red in ((jax_get_config, jax_reduced), (get_config, reduced)):
        cfg = red(get(ARCH).model, max_seq_len=32)
        out.append(dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=q_lora)))
    return out


def _inputs(jcfg, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jax_layers.init_attention(
        jax.random.PRNGKey(seed), jcfg))
    x = np.random.RandomState(seed + 1).randn(B, S, jcfg.d_model)
    return p, x.astype(np.float32)


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_init_matches_reference(q_lora):
    jcfg, tcfg = _cfgs(q_lora)
    want = jax_layers.init_attention(jax.random.PRNGKey(4), jcfg)
    got = L.init_attention(prng.prng_key(4), tcfg, device="cpu")
    assert set(got) == set(want)
    assert ("wq_a" in got) == bool(q_lora)
    assert jax.tree_util.tree_structure(params_to_numpy(got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_full_sequence_matches_reference(q_lora):
    jcfg, tcfg = _cfgs(q_lora)
    p, x = _inputs(jcfg)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, cache_j = jax_layers.attention_forward(p, jnp.asarray(x), jcfg,
                                                 positions=jnp.asarray(pos))
    with torch.no_grad():
        got, cache_t = L.attention_forward(
            params_from_numpy(p, "cpu"), torch.from_numpy(x), tcfg,
            positions=torch.from_numpy(pos.copy()))
    assert cache_j is None and cache_t is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_decode_matches_reference(q_lora):
    """x fed one position at a time against latent caches of 16 slots:
    each step's output and, at the end, the caches; the last step equals
    the full sequence's last position."""
    jcfg, tcfg = _cfgs(q_lora)
    p, x = _inputs(jcfg, seed=2)
    tp = params_from_numpy(p, "cpu")
    jc = jax_layers.init_kv_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = L.init_kv_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, x, pos, c, i: jax_layers.attention_forward(
        p, x, jcfg, positions=pos, cache=c, cache_index=i))
    for t in range(S):
        pos = np.full((B, 1), t, np.int32)
        want, jc = step(p, x[:, t:t + 1], pos, jc, jnp.int32(t))
        with torch.no_grad():
            got, tc = L.attention_forward(
                tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                positions=torch.from_numpy(pos),
                cache=tc, cache_index=torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    for name in ("ckv", "kpe", "pos"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(tc["pos"][0, S - 1]) == S - 1 and int(tc["pos"][0, S]) == -1
    with torch.no_grad():
        full, _ = L.attention_forward(
            tp, torch.from_numpy(x), tcfg,
            positions=torch.arange(S, dtype=torch.int32).expand(B, S))
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mla_cache_is_latent_sized():
    """As the reference's ``tests/test_models.py`` checks it: the latent
    cache and its size against a full per-head KV cache, and the same
    shapes as the reference's caches."""
    cfg = reduced(get_config(ARCH).model)
    caches = torch_model.init_caches(cfg, 2, 64, dtype=torch.bfloat16,
                                     device="cpu")
    layer = caches["layers"][0]
    assert set(layer) == {"ckv", "kpe", "pos"}
    assert tuple(layer["ckv"].shape) == (2, 64, cfg.mla.kv_lora_rank)
    assert tuple(layer["kpe"].shape) == (2, 64, cfg.mla.qk_rope_head_dim)
    full_kv = 2 * 64 * cfg.n_heads * (cfg.mla.qk_nope_head_dim
                                      + cfg.mla.qk_rope_head_dim) * 2
    latent = layer["ckv"].numel() + layer["kpe"].numel()
    assert latent * 3 < full_kv
    want = jax_model.init_caches(jax_reduced(jax_get_config(ARCH).model), 2,
                                 64, dtype=jnp.bfloat16)
    for got_l, want_l in zip(caches["layers"], want["layers"]):
        assert {k: tuple(v.shape) for k, v in got_l.items()} == \
            {k: v.shape for k, v in want_l.items()}
        assert got_l["pos"].dtype == torch.int32
        assert bool((got_l["pos"] == -1).all())
