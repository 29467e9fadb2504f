"""The paper's CNN experiment pieces: ``SyntheticImages`` and
``models/cnn.py``, the port against the reference.

The arrays and batches must be bit-identical (same numpy generator, same
epoch shuffle).  The port keeps the reference's parameter layout (HWIO
convolutions, ``fc1`` rows in NHWC flatten order) and computes NCHW
inside ``cnn_forward``, so the reference's parameters go across with
``interop.params_from_numpy`` unchanged and come back unchanged.  Logits,
loss and accuracy agree within rtol 1e-5 (f32 convolutions summed in
another order); gradients within rtol 1e-4 and atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticImages as JaxImages
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro.models.cnn import cnn_loss as jax_cnn_loss
from repro.models.cnn import init_cnn as jax_init_cnn
from repro_torch.core.averaging import value_and_grad
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.cnn import cnn_forward, cnn_loss, init_cnn
from repro_torch.tree import tree_leaves

WIDTHS = [(8, 16), (16, 32), (32, 64, 128)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU side on one thread (see ``test_torch_clock.py``):
    under the test runner's parallel workers, several processes' thread
    pools spin against each other and slow these tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(widths, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_cnn(jax.random.PRNGKey(seed), widths=widths))


@pytest.mark.parametrize("n,seed", [(128, 0), (300, 3)])
def test_synthetic_images_identical(n, seed):
    got, want = SyntheticImages(n_samples=n, seed=seed), \
        JaxImages(n_samples=n, seed=seed)
    for name in ("protos", "labels", "images"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tb = got.batches(n_replicas=4, per_replica_batch=8, device="cpu")
    jb = want.batches(n_replicas=4, per_replica_batch=8)
    # a few epochs: the per-epoch reshuffle must agree too
    for step in range(3 * tb.steps_per_epoch + 1):
        t, j = tb(step), jb(step)
        assert set(t) == set(j) == {"images", "labels"}
        for k in t:
            assert t[k].shape == (4, 8, *j[k].shape[2:])
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for t, j in zip(got.eval_batches(100, device="cpu"),
                    want.eval_batches(100)):
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("widths", WIDTHS)
def test_forward_and_loss_match_reference(widths):
    params = _ref_params(widths)
    data = JaxImages(n_samples=64, seed=1)
    x, y = data.images[:16], data.labels[:16]
    want = np.asarray(jax_cnn_forward(params, jnp.asarray(x)))
    tparams = params_from_numpy(params, "cpu")
    with torch.no_grad():
        got = cnn_forward(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    loss, aux = cnn_loss(tparams, batch)
    jloss, jaux = jax_cnn_loss(params, {"images": jnp.asarray(x),
                                        "labels": jnp.asarray(y)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce_loss"]), float(jaux["ce_loss"]),
                               rtol=1e-5)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])


@pytest.mark.parametrize("widths", WIDTHS[:2])
def test_gradients_match_reference(widths):
    params = _ref_params(widths, seed=2)
    data = JaxImages(n_samples=64, seed=2)
    batch = {"images": data.images[:8], "labels": data.labels[:8]}
    (_, _), jgrads = jax.value_and_grad(jax_cnn_loss, has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    _, _, grads = value_and_grad(
        cnn_loss, params_from_numpy(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("widths", WIDTHS)
def test_interop_round_trip(widths):
    params = _ref_params(widths)
    back = params_to_numpy(params_from_numpy(params, "cpu"))
    got, want = tree_leaves(back), jax.tree_util.tree_leaves(params)
    assert len(got) == len(want) == 2 * len(widths) + 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    stacked = np.stack([params["fc1"]["w"]] * 3)     # a replica axis rides
    assert np.array_equal(params_to_numpy(
        params_from_numpy({"w": stacked}, "cpu"))["w"], stacked)


@pytest.mark.parametrize("widths", WIDTHS)
def test_init_matches_reference_tree(widths):
    """Same leaves, shapes and order as the reference's init (QSGD prices
    one norm per tensor), and the same values from the same seed to rtol
    5e-7 (``prng.normal``'s bound); zero biases."""
    got = init_cnn(0, widths=widths, device="cpu")
    want = _ref_params(widths)
    assert [tuple(x.shape) for x in tree_leaves(got)] == \
        [x.shape for x in jax.tree_util.tree_leaves(want)]
    assert all(x.dtype == torch.float32 for x in tree_leaves(got))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-7,
                                   atol=0)
    for conv in got["convs"]:
        assert not conv["b"].any()
    n = sum(x.numel() for x in tree_leaves(got))
    if widths == (16, 32):
        assert n == 532_202                  # benchmarks/common.py's CNN
