"""The grouped mean + sqdev kernel's plan and CPU route.

``mean_and_sqdev_many`` covers every leaf of a tree in one launch on the
card; here, on the CPU, it takes the plain route, which must stay bitwise
the per-leaf loop the sync ran before (plain mean, ``copy_``, the sum of
the leaves' sq in leaf order).  The tile plan, which the CUDA kernel walks,
is plain Python and is checked here: every column of every leaf in exactly
one tile.  The sum over a small tree is held against the reference's Pallas
kernel in interpret mode (means atol 1e-6 and sq rtol 1e-5, as
``tests/test_torch_kernels.py``: f32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.param_variance import mean_and_sqdev as jax_mean_and_sqdev
from repro_torch.backends import VmapBackend
from repro_torch.core.averaging import sync_replicas
from repro_torch.kernels import ops as torch_ops
from repro_torch.kernels import param_variance as pv
from repro_torch.kernels import ref as torch_ref

# per-replica leaf shapes: 1-element leaves, ragged and 16-byte widths, a
# leaf of several tiles and one past a tile by one column
TREES = {
    "small": [(), (7,), (5, 4, 3), (1024,), (33, 7), (3, 3)],
    "ones": [(), (1,), (1, 1)],
    "ragged": [(2048 * 3 + 5,), (9000,), (1,), (4096 + 4,), (8193,)],
}
RS = [1, 2, 4, 8, 16]


def _tree(shapes, R, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(R, *s).astype(np.float32))
            for s in shapes]


def _sizes(shapes):
    return tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("tree", list(TREES))
def test_tile_plan_covers_every_column_once(tree, R):
    cols = _sizes(TREES[tree])
    plan = pv.tile_plan(cols, R)
    covered = [np.zeros(n, dtype=np.int64) for n in cols]
    last = (-1, -1)
    for t in range(plan.n_tiles):
        leaf, lo, hi = plan.tile(t)
        assert 0 <= lo < hi <= cols[leaf] and hi - lo <= plan.tile_cols
        assert (leaf, lo) > last            # leaf order, then column order
        last = (leaf, lo)
        covered[leaf][lo:hi] += 1
    assert all((c == 1).all() for c in covered)
    assert plan.tile_cols == pv.tile_cols(R) and plan.tile_cols % 1024 == 0
    assert plan.vec == tuple(n % 4 == 0 for n in cols)
    assert all(o % 4 == 0 for o in plan.out_off)
    ends = [o + n for o, n in zip(plan.out_off, cols)]
    assert all(e <= o for e, o in zip(ends, plan.out_off[1:]))
    assert plan.out_numel("delta") == R * plan.out_numel("mean") >= R * ends[-1]


@pytest.mark.parametrize("R", RS)
def test_tile_plan_is_a_function_of_sizes_and_R(R):
    cols = _sizes(TREES["ragged"])
    a = pv.tile_plan(cols, R)
    pv.tile_plan.cache_clear()
    b = pv.tile_plan(tuple(list(cols)), R)
    assert a == b and a is not b
    assert pv.grid_blocks(a.n_tiles) % pv.SMS == 0
    assert pv.grid_blocks(1) == pv.SMS
    assert pv.grid_blocks(10**6) == pv.SMS * pv.BLOCKS_PER_SM


def _old_sync(leaves):
    """The sync's kernel route on the CPU before the grouped kernel: plain
    mean and sqdev per leaf, ``copy_``, the sum of the sq over R."""
    sks = []
    for x in leaves:
        mean, sk = torch_ref.mean_and_sqdev_ref(x)
        x.copy_(mean.unsqueeze(0).expand_as(x))
        sks.append(sk)
    return sum(sks) / leaves[0].shape[0], sks


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("mode", ["mean", "sync", "delta"])
def test_cpu_route_is_the_plain_per_leaf_route(tree, R, mode):
    base = _tree(TREES[tree], R, seed=R)
    leaves = [x.clone() for x in base]
    out = None if mode == "sync" else pv.new_out(leaves, mode)
    before = (pv.mean_and_sqdev.launches, pv.mean_and_sqdev.leaves)
    sq, s_k = torch_ops.param_mean_and_sqdev_many(leaves, mode, out)
    assert (pv.mean_and_sqdev.launches, pv.mean_and_sqdev.leaves) == before
    old = [x.clone() for x in base]
    want_s_k, want_sq = _old_sync(old)
    assert torch.equal(s_k, want_s_k) and torch.equal(sq, torch.stack(want_sq))
    if mode == "sync":
        assert all(torch.equal(x, o) for x, o in zip(leaves, old))
        return
    assert all(torch.equal(x, b) for x, b in zip(leaves, base))
    for v, x, o in zip(pv.out_views(out, leaves, mode), base, old):
        want = o[0] if mode == "mean" else o[0].unsqueeze(0) - x
        assert v.shape == want.shape and torch.equal(v, want)


@pytest.mark.parametrize("R", [2, 4])
def test_sync_and_snapshot_match_the_old_cpu_routes(R):
    """``sync_replicas(use_kernel=True)`` and DaSGD's snapshot with the
    kernel on, on the CPU: bitwise today's loop (sync) and the plain
    snapshot (delta values and S_k); the deltas are views of one buffer."""
    shapes = TREES["small"] + TREES["ragged"]
    base = _tree(shapes, R, seed=7)
    W = {"a": [x.clone() for x in base[:4]], "n": {},
         "b": {"c": [x.clone() for x in base[4:]]}}
    flat = W["a"] + W["b"]["c"]
    _, _, s_k = sync_replicas(W, use_kernel=True)
    old = [x.clone() for x in base]
    want, _ = _old_sync(old)
    assert torch.equal(s_k, want)
    assert all(torch.equal(x, o) for x, o in zip(flat, old))

    W = {"a": [x.clone() for x in base]}
    d_k, s_kernel = VmapBackend(use_kernel=True, device="cpu").mean_delta()(W)
    d_p, s_plain = VmapBackend(use_kernel=False, device="cpu").mean_delta()(W)
    assert torch.equal(s_kernel, s_plain)
    assert all(torch.equal(a, b) for a, b in zip(d_k["a"], d_p["a"]))
    assert all(torch.equal(x, b) for x, b in zip(W["a"], base))
    storage = {d.untyped_storage().data_ptr() for d in d_k["a"]}
    assert len(storage) == 1


@pytest.mark.parametrize("R", [2, 4, 8, 16])
def test_cpu_route_against_pallas_interpret(R):
    shapes = [(100,), (33, 7), (5, 4, 3), (1024,)]
    leaves = _tree(shapes, R, seed=3 * R)
    out = pv.new_out(leaves, "mean")
    sq, s_k = pv.mean_and_sqdev_many(leaves, "mean", out)
    total = 0.0
    for x, m, s in zip(leaves, pv.out_views(out, leaves, "mean"), sq):
        m_pl, sq_pl = jax_mean_and_sqdev(jnp.asarray(x.numpy()), interpret=True)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_pl), atol=1e-6)
        np.testing.assert_allclose(float(s), float(sq_pl), rtol=1e-5,
                                   atol=1e-6)
        total += float(sq_pl)
    np.testing.assert_allclose(float(s_k), total / R, rtol=1e-5)


def _bad(case):
    x = torch.zeros(4, 8)
    return {
        "no_leaves": ([], "sync", None, ValueError),
        "dtype": ([x, torch.zeros(4, 8, dtype=torch.float64)], "sync", None,
                  TypeError),
        "bf16": ([torch.zeros(4, 8, dtype=torch.bfloat16)], "sync", None,
                 TypeError),
        "strided": ([x, torch.zeros(8, 4).T], "sync", None, ValueError),
        "replica_axes": ([x, torch.zeros(2, 16)], "sync", None, ValueError),
        "scalar": ([torch.zeros(())], "sync", None, ValueError),
        "empty": ([x, torch.zeros(4, 0)], "sync", None, ValueError),
        "devices": ([x, torch.zeros(4, 8, device="meta")], "sync", None,
                    ValueError),
        "mode": ([x], "all", None, ValueError),
        "no_out": ([x], "delta", None, ValueError),
        "sync_out": ([x], "sync", torch.zeros(8), ValueError),
        "out_size": ([x], "mean", torch.zeros(9), ValueError),
        "out_dtype": ([x], "delta", torch.zeros(32, dtype=torch.float64),
                      ValueError),
    }[case]


@pytest.mark.parametrize("case", ["no_leaves", "dtype", "bf16", "strided",
                                  "replica_axes", "scalar", "empty",
                                  "devices", "mode", "no_out", "sync_out",
                                  "out_size", "out_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    leaves, mode, out, err = _bad(case)
    with pytest.raises(err):
        pv.mean_and_sqdev_many(leaves, mode, out)
