"""Every strategy on the port's mesh backend, over gloo groups of 2 and 4
CPU processes (``torch_mesh_ranks.py``), against the port's ``vmap``
backend: the counterparts of the reference's ``test_matrix_parity``,
``test_byte_true_exchange_bit_parity`` and
``test_replica_step_hlo_has_no_collectives``.

The matrix: the nine strategies on the setup8 CNN (R = 8, momentum, 12
steps) at world 2 under ``SimulatedClock("10gbps")`` — the identical
schedule (sync, inner-sync and period histories), losses rtol 2e-4 /
atol 1e-5, S_k rtol 1e-3 / atol 1e-5, ``sim_wall_s`` equal, and the
final W rtol 1e-4 / atol 1e-5 for every strategy.  ``qsgd_periodic``'s
anchor is seeded by a full-precision mean, which the mesh sums in another
order (the ranks' chunk means); an ulp there moves a quantization level
where a uniform lies within an ulp of its fraction, so a few elements of
its W differ by whole quanta (norm/(127·R); measured: one element of
one leaf, 3.1e-3): at most 4 elements a replica may, each within 1e-2,
while its losses agree to 1.1e-7.  The exchange itself, fed
the same (W, anchor, key), is bitwise the ``vmap`` backend's at worlds 2
and 4, and each rank hands all_gather exactly ``n_local ×
payload_bytes(n_params, n_tensors)`` bytes.

Collectives, counted by wrapping ``torch.distributed``'s functions, on
the CNN (8 leaves) and the narrow OLMo (more): a local step issues none
but the metrics mean (one all-reduce of a few floats, outside the step);
a sync issues two (the mean bucket and S_k) whatever the leaf count; a
quantized sync one all_gather; DaSGD's snapshot one asynchronous
all-reduce, its apply one (S_k).  ``hier_adpsgd`` with groups inside a
rank's chunk issues nothing for an inner sync; with groups of two ranks,
one all-reduce in a subgroup.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as jax_model
from repro_torch.backends.ops import quantized_all_mean_op
from repro_torch.strategies import available_strategies

METHODS = sorted(available_strategies())
STEPS = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(model):
    if model == "cnn":
        p = jax_init_cnn(jax.random.PRNGKey(0), widths=(8, 16))
    else:
        cfg = jax_reduced(jax_get_config("olmo-1b").model, max_seq_len=32)
        p = jax_model.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _train(method, **kw):
    return dict(kind="train", name=method, model="cnn", method=method,
                params=_params("cnn"), steps=STEPS, clock="10gbps", **kw)


def _counts(model, method, **kw):
    return dict(dict(kind="counts", name=f"counts-{model}-{method}",
                     model=model, method=method, params=_params(model),
                     steps=6), **kw)


HIER = {"inside": (2, 2), "across": (4, 4)}   # (world, group_size) at R=8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_strategies")
    exchange = dict(kind="exchange", name="exchange", R=8,
                    params=_params("cnn"))
    hier = {name: _counts("cnn", "hier_adpsgd", avg={"group_size": g},
                          steps=STEPS)
            for name, (_, g) in HIER.items()}
    two = ([_train(m) for m in METHODS]
           + [_counts(m, meth) for m in ("cnn", "olmo")
              for meth in ("adpsgd", "qsgd_periodic")]
           + [_counts("cnn", "dasgd", steps=STEPS)]
           + [exchange, hier["inside"],
              dict(kind="inflight", name="inflight", model="cnn",
                   method="adpsgd", params=_params("cnn"))])
    four = [exchange, hier["across"]]
    groups = {2: ranks.Group(2, two, tmp),
              4: ranks.Group(4, four, tmp)}
    out = {"vmap": {}}
    for m in METHODS:
        e = ranks.make_engine(dict(_train(m), backend="vmap"))
        out["vmap"][m] = ranks.history(e, e.run())
    for name, sc in hier.items():
        e = ranks.make_engine(dict(sc, backend="vmap"))
        out["vmap"][f"hier-{name}"] = ranks.history(e, e.run())
    for world, group in groups.items():
        out[world] = group.wait()[0]
    return out


# ------------------------------------------------------------- the matrix
@pytest.mark.parametrize("method", METHODS)
def test_matrix_parity(runs, method):
    got, want = runs[2][method]["mesh"], runs["vmap"][method]
    for k in ("sync_steps", "periods", "inner_sync_steps", "n_syncs"):
        assert got[k] == want[k], k
    assert got["n_syncs"] >= 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["s_k"], want["s_k"], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_matrix_final_params(runs, method):
    """rtol 1e-4 / atol 1e-5; for qsgd_periodic every element but a few
    flipped levels, which move the replica mean by whole quanta
    (norm/(127·R): 3.1e-3 here, one flip) and are held to 1e-2."""
    got, want = runs[2][method]["mesh"], runs["vmap"][method]
    for a, b in zip(got["W"], want["W"]):
        if method != "qsgd_periodic":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            continue
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert off.sum() <= 4 * len(a), off.sum()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("method", METHODS)
def test_simulated_clock_prices_the_mesh_as_vmap(runs, method):
    """The wire bytes come from the op and the per-replica parameter
    count, whatever share of the replicas a rank holds."""
    got, want = runs[2][method]["mesh"], runs["vmap"][method]
    assert got["sim_wall_s"] == want["sim_wall_s"] > 0


# ------------------------------------------------------- byte-true QSGD
@pytest.mark.parametrize("world", [2, 4])
def test_byte_true_exchange_bitwise(runs, world):
    got = runs[world]["exchange"]
    mesh, vmap = got["mesh"], got["vmap"]
    assert mesh["s_k"] == vmap["s_k"]
    for a, b in zip(mesh["anchor"], vmap["anchor"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mesh["W"], vmap["W"]):
        np.testing.assert_array_equal(a, b)
    payload = quantized_all_mean_op(8).payload_bytes(got["n_params"],
                                                     got["n_tensors"])
    assert mesh["calls"] == [("all_gather", mesh["n_local"] * payload)]
    assert vmap["calls"] == []


@pytest.mark.parametrize("model", ["cnn", "olmo"])
def test_quantized_sync_hands_all_gather_the_payload(runs, model):
    got = runs[2][f"counts-{model}-qsgd_periodic"]
    payload = quantized_all_mean_op(8).payload_bytes(got["n_params"],
                                                     got["n_leaves"])
    syncs = [calls for name, calls, _ in got["log"] if name == "sync"]
    assert len(syncs) == got["n_syncs"] >= 3
    # the first sync seeds the anchor at full precision: the sync's two
    # collectives and the anchor's mean
    assert [op for op, _ in syncs[0]] == ["all_reduce"] * 3
    for calls in syncs[1:]:
        assert calls == [("all_gather", got["n_local"] * payload)]


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("model", ["cnn", "olmo"])
def test_local_step_issues_no_collective(runs, model):
    """The counterpart of test_replica_step_hlo_has_no_collectives: the
    step's only collective is the metrics mean, one all-reduce of its
    few scalars, issued apart from the local step."""
    got = runs[2][f"counts-{model}-adpsgd"]
    steps = [(calls, tagged) for name, calls, tagged in got["log"]
             if name == "step"]
    assert len(steps) == 6
    for calls, tagged in steps:
        assert tagged == 1
        assert len(calls) == 1 and calls[0][0] == "all_reduce"
        assert calls[0][1] <= 4 * 8          # loss, grad_norm, aux (f32)


def test_sync_collectives_do_not_depend_on_the_leaves(runs):
    cnn = runs[2]["counts-cnn-adpsgd"]
    olmo = runs[2]["counts-olmo-adpsgd"]
    assert cnn["n_leaves"] < olmo["n_leaves"]
    for got in (cnn, olmo):
        syncs = [calls for name, calls, _ in got["log"] if name == "sync"]
        assert len(syncs) == got["n_syncs"] >= 3
        for calls in syncs:
            assert [op for op, _ in calls] == ["all_reduce", "all_reduce"]
            assert calls[0][1] == 4 * got["n_params"]   # the mean bucket
            assert calls[1][1] == 4                     # S_k


def test_dasgd_snapshot_and_apply_collectives(runs):
    got = runs[2]["counts-cnn-dasgd"]
    by = {}
    for name, calls, _ in got["log"]:
        by.setdefault(name, []).append([op for op, _ in calls])
    assert by["sync"] and all(c == ["all_reduce"] for c in by["sync"])
    assert by["sync_apply"] and all(c == ["all_reduce"]
                                    for c in by["sync_apply"])


def test_dasgd_snapshot_is_pending_until_fetch(runs):
    got = runs[2]["inflight"]
    assert got["pending_before_fetch"] and got["fetched"]
    for a, b in zip(got["delta"], got["want"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["s_k"], got["want_s_k"], rtol=1e-5)


# ----------------------------------------------------------- hierarchical
@pytest.mark.parametrize("where", list(HIER))
def test_hier_groups(runs, where):
    world, g = HIER[where]
    got = runs[world]["counts-cnn-hier_adpsgd"]
    want = runs["vmap"][f"hier-{where}"]
    for k in ("sync_steps", "periods", "inner_sync_steps"):
        assert got[k] == want[k], k
    assert got["inner_sync_steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=1e-5)
    for a, b in zip(got["W"], want["W"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    inner = [calls for name, calls, _ in got["log"] if name == "inner_sync"]
    want_calls = [] if got["n_local"] % g == 0 else ["all_reduce"]
    assert inner and all([op for op, _ in c] == want_calls for c in inner)
