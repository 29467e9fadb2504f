"""The dry run and what it stands on: ``launch/steps.py::make_steps``,
``core/comm_model.py::roofline_terms``, the kernels' meta branches
(``kernels/cost.py``) and ``launch/dryrun.py``, against the reference
where it has a counterpart and against real CPU runs where it counts.

* ``make_steps``' three programs on reduced OLMo-1B (R = 4, adamw) against
  the reference's: losses and S_k within rtol 1e-4, W within 0.05·lr
  (the parity bounds of the port's engine tests).
* ``roofline_terms`` is the reference's arithmetic under the H100 rates;
  ``_affine_extrapolate``, ``pair_is_runnable`` and the ring factors give
  the reference's numbers for ``tests/test_dryrun_analysis.py``'s cases.
* Meta counts against a CPU run: FLOPs equal ``FlopCounterMode``'s,
  argument bytes the real tensors' bytes, and the sync's kernel calls.
* A fake data 2 x model 2 mesh: the backend's own collectives of a local
  step and a sync, by group, as ``tests/test_torch_mesh_tp.py`` observes
  them on gloo; DTensor's own collectives over the model group.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import comm_model as jax_comm_model
from repro.launch import steps as jax_steps
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.core import comm_model
from repro_torch.core.averaging import stack_replicas
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import param_variance as pv
from repro_torch.kernels import qsgd_quant as qq
from repro_torch.launch import dryrun, specs, steps
from repro_torch.launch.mesh import make_dryrun_mesh
from repro_torch.tree import tree_leaves

R, B, S, LR = 4, 2, 32, 4e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share the host's cores: torch's thread pool
    would spin against the others' and slow these small steps tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dryrun module; importing it writes XLA_FLAGS (inert
    once jax is up), which is put back for the processes this one
    starts."""
    old = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


def _olmo_runs():
    run = get_config("olmo-1b")
    ref = jax_get_config("olmo-1b")
    return (run.replace(model=reduced(run.model, max_seq_len=S)),
            ref.replace(model=jax_reduced(ref.model, max_seq_len=S)))


def _batches(vocab, n):
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, vocab, (R, B, S)).astype(np.int32)}
            for _ in range(n)]


# ------------------------------------------------------------- make_steps
def test_make_steps_match_the_references():
    run, ref = _olmo_runs()
    from repro.models import model as jax_model
    p0 = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jax.random.PRNGKey(0), ref.model))
    W0 = jax.tree_util.tree_map(lambda x: np.stack([x] * R), p0)
    jf, tf = jax_steps.make_steps(ref), steps.make_steps(run)
    assert set(tf) == set(jf)
    jW = jax.tree_util.tree_map(jnp.asarray, W0)
    jopt = jax.vmap(jf["optimizer"].init)(jW)
    tW = params_from_numpy(W0, "cpu")
    topt = tf["optimizer"].init(tW, n_replicas=R)
    local, full = jax.jit(jf["local_step"]), jax.jit(jf["full_step"])
    sync = jax.jit(jf["sync_step"])
    for k, b in enumerate(_batches(run.model.vocab_size, 5)):
        prog = ("local_step", "local_step", "full_step", "local_step",
                "full_step")[k]
        fn = {"local_step": local, "full_step": full}[prog]
        jW, jopt, jm = fn(jW, jopt, jax.tree_util.tree_map(jnp.asarray, b),
                          LR)
        tW, topt, tm = tf[prog](tW, topt, params_from_numpy(b, "cpu"), LR)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        if k in (1, 4):
            jW, jopt, js = sync(jW, jopt)
            tW, topt, ts = tf["sync_step"](tW, topt)
            np.testing.assert_allclose(float(ts), float(js), rtol=1e-4)
    for a, b in zip(tree_leaves(tW), jax.tree_util.tree_leaves(jW)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=0.05 * LR)


# ------------------------------------------------------ the reference's math
def test_roofline_terms_is_the_references_arithmetic(monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jax_comm_model, name, getattr(comm_model, name))
    assert (comm_model.PEAK_FLOPS_BF16, comm_model.HBM_BW,
            comm_model.ICI_BW) == (989e12, 3.35e12, 450e9)
    for args in [(1e15, 1e12, 1e9, 256), (1e12, 5e12, 0.0, 1),
                 (2e14, 1e11, 4e11, 8, 2)]:
        assert comm_model.roofline_terms(*args) == \
            jax_comm_model.roofline_terms(*args)


def test_extrapolation_and_runnability_are_the_references(jax_dryrun):
    a1 = {"flops_per_chip": 10.0, "hbm_bytes_per_chip": 100.0,
          "collective_bytes_per_chip": 5.0,
          "collectives": {"bytes_by_type": {"all-reduce": 5.0},
                          "count_by_type": {"all-reduce": 1}}}
    a2 = {"flops_per_chip": 16.0, "hbm_bytes_per_chip": 140.0,
          "collective_bytes_per_chip": 7.0,
          "collectives": {"bytes_by_type": {"all-reduce": 6.0,
                                            "all-gather": 1.0},
                          "count_by_type": {"all-reduce": 2}}}
    got = dryrun._affine_extrapolate(a1, a2, 1, 2, 12)
    want = jax_dryrun._affine_extrapolate(a1, a2, 1, 2, 12)
    assert got.keys() == want.keys()
    for k in ("flops_per_chip", "hbm_bytes_per_chip",
              "collective_bytes_per_chip"):
        assert got[k] == pytest.approx(want[k])
    assert got["collectives"]["bytes_by_type"] == pytest.approx(
        want["collectives"]["bytes_by_type"])
    assert got["collectives"]["count_by_type"] == \
        want["collectives"]["count_by_type"]
    assert dryrun.ARCHS == jax_dryrun.ARCHS
    assert dryrun.LONG_OK == jax_dryrun.LONG_OK
    pairs = [(a, s) for a in dryrun.ARCHS
             for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    assert [dryrun.pair_is_runnable(*p) for p in pairs] == \
        [jax_dryrun.pair_is_runnable(*p) for p in pairs]
    assert sum(dryrun.pair_is_runnable(*p) for p in pairs) == 33


def test_ring_factors_are_the_references(jax_dryrun):
    """``test_parse_collectives_factors``' HLO, as (op, result bytes,
    group size) calls."""
    hlo = """
  %ar = f32[16,1024]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[4096,128]{1,0} all-gather(%y), replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %rs = f32[64]{0} reduce-scatter(%z), replica_groups=[64,4]<=[256], dimensions={0}
  %a2a = f32[8,8]{1,0} all-to-all(%w), replica_groups=[32,8]<=[256]
  %cp = f32[100]{0} collective-permute(%v), source_target_pairs={{0,1}}
  %solo = f32[9]{0} all-reduce(%q), replica_groups=[256,1]<=[256], to_apply=%add
"""
    calls = [("all-reduce", 16 * 1024 * 4, 16, "data"),
             ("all-gather", 4096 * 128 * 2, 16, "model"),
             ("reduce-scatter", 64 * 4, 4, "model"),
             ("all-to-all", 8 * 8 * 4, 8, "model"),
             ("collective-permute", 100 * 4, 2, "data"),
             ("all-reduce", 9 * 4, 1, "data")]
    got = dryrun.collective_bytes(calls)
    want = jax_dryrun.parse_collectives(hlo)
    assert got["bytes_by_type"] == pytest.approx(want["bytes_by_type"])
    assert got["count_by_type"] == want["count_by_type"]
    assert got["total_bytes"] == pytest.approx(want["total_bytes"])
    assert got["bytes_by_axis"] == pytest.approx(
        {"data": 16 * 1024 * 4 * 2 * 15 / 16 + 400,
         "model": 4096 * 128 * 2 * 15 / 16 + 64 * 4 * 3 + 8 * 8 * 4 * 7 / 8})


# -------------------------------------------------- the kernels' meta branch
def _launches():
    return (pv.mean_and_sqdev.launches, pv.mean_and_sqdev.leaves,
            qq.sqnorm.launches, qq.quantize.launches, qq.dequantize.launches,
            fa.flash_attention.launches)


def test_kernel_wrappers_on_meta_record_costs_and_launch_nothing():
    meta = dict(device="meta")
    leaves = [torch.empty(4, 3, 5, **meta), torch.empty(4, 7, **meta)]
    x = torch.empty(1000, **meta)
    q = torch.empty(2, 256, 8, 64, dtype=torch.bfloat16, **meta)
    kv = torch.empty(2, 256, 2, 64, dtype=torch.bfloat16, **meta)
    before = _launches()
    with dryrun.CostMode() as mode:
        sq, s_k = pv.mean_and_sqdev_many(leaves, "sync")
        m, s1 = pv.mean_and_sqdev(leaves[0])
        n = qq.sqnorm_many([x] * 70)
        lv = qq.quantize(x, torch.empty(1000, **meta),
                         torch.empty(1, **meta))
        dq = qq.dequantize(lv, torch.empty(1, **meta))
        o = fa.flash_attention(q, kv, kv, causal=True)
    assert _launches() == before
    assert (sq.shape, s_k.shape, m.shape, s1.shape) == \
        ((2,), (), (3, 5), ())
    assert n.shape == (70,) and lv.dtype == torch.int8 and lv.shape == x.shape
    assert dq.dtype == torch.float32 and o.shape == q.shape \
        and o.dtype == torch.bfloat16
    shapes = [(4, 3, 5), (4, 7)]
    k = mode.kernels
    assert k["mean_and_sqdev"]["calls"] == 2
    assert k["mean_and_sqdev"]["bytes"] == \
        cost.fused_sync_cost(shapes)[0] + cost.mean_sqdev_cost(shapes[:1])[0]
    assert k["sqnorm"] == {"calls": 2, "bytes": 4.0 * 70000,
                           "ops": 2.0 * 70000}
    assert k["quantize"]["bytes"] == 9000 and k["dequantize"]["ops"] == 1000
    want = cost.flash_cost(2, 256, 256, 8, 2, 64, True, 0, 2)
    assert (k["flash_attention"]["bytes"], k["flash_attention"]["ops"]) == \
        want[:2]
    with pytest.raises(ValueError, match="head dims"):
        d48 = torch.empty(1, 128, 2, 48, dtype=torch.bfloat16, **meta)
        fa.flash_attention(d48, d48, d48)


def test_bounds_are_chip_smokes_numbers():
    """The bounds ``chip_smoke.py`` prints moved into ``kernels/cost.py``
    unchanged (OLMo-1B's embedding leaf at R = 4, its prefill layer)."""
    assert cost.mean_sqdev_bound([(4, 50304, 2048)]) == cost.bound(
        (4 + 1) * 50304 * 2048 * 4, 4 * 4 * 50304 * 2048)
    ms, by = cost.flash_bound((4, 2048, 16, 16, 128))
    pairs = 2048 * 2049 // 2
    assert cost.attention_pairs(2048, 2048, True, 0) == pairs
    assert ms == pytest.approx(
        max(4 * 2048 * 16 * 128 * 4 * 2 / 3.35e12,
            4 * 128 * 4 * 16 * pairs / 989e12) * 1e3)
    assert by == "operations"


# -------------------------------------------- meta counts against a CPU run
def test_meta_counts_equal_a_cpu_run():
    run, _ = _olmo_runs()
    cfg = run.model
    fns = steps.make_steps(run)
    from repro_torch.models import model as M
    W = stack_replicas(M.init_params(0, cfg, device="cpu"), R)
    opt = fns["optimizer"].init(W, n_replicas=R)
    batch = params_from_numpy(_batches(cfg.vocab_size, 1)[0], "cpu")
    mW = specs.abstract_params(cfg, n_replicas=R)
    mopt = specs.abstract_opt_state(fns["optimizer"], mW, stacked=True)
    mbatch = {"tokens": torch.empty((R, B, S), dtype=torch.int32,
                                    device="meta")}
    _, loc = dryrun.analyze(fns["local_step"], (mW, mopt, mbatch, LR))
    _, syn = dryrun.analyze(fns["sync_step"], (mW, mopt))
    with FlopCounterMode(display=False) as fc:
        fns["local_step"](W, opt, batch, LR)
    assert loc["aten_flops_per_chip"] == fc.get_total_flops() > 0
    assert loc["flops_per_chip"] == loc["aten_flops_per_chip"]
    state = sum(x.numel() * x.element_size() for x in tree_leaves((W, opt)))
    assert loc["memory"]["argument_bytes"] == state + batch["tokens"].nbytes
    assert syn["memory"]["argument_bytes"] == state
    assert loc["memory"]["temp_bytes"] > 0 and loc["kernels"] == {}
    shapes = [tuple(x.shape) for x in tree_leaves(W)]
    assert syn["kernels"] == {"mean_and_sqdev": {
        "calls": 1, "bytes": float(cost.fused_sync_cost(shapes)[0]),
        "ops": float(cost.fused_sync_cost(shapes)[1])}}
    assert syn["roofline"] == comm_model.roofline_terms(
        syn["flops_per_chip"], syn["hbm_bytes_per_chip"], 0.0, 1)
    # the least traffic: W and the optimizer state read and written once,
    # the batch read, the metrics written; the sync reads and writes W
    # alone (adamw's moments are not synced)
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(W))
    assert loc["io_bytes_per_chip"] == 2 * state + batch["tokens"].nbytes \
        + loc["memory"]["output_bytes"]
    assert syn["io_bytes_per_chip"] == 2 * w_bytes + 4
    assert syn["roofline_io"] == comm_model.roofline_terms(
        syn["flops_per_chip"], syn["io_bytes_per_chip"], 0.0, 1)


def test_depth_correction_is_exact_for_a_dense_model():
    """A scanned 6-layer reduced OLMo: FLOPs and bytes extrapolated from
    depths 1 and 2 equal the 6-layer build's."""
    run, _ = _olmo_runs()
    run = run.replace(model=dataclasses.replace(run.model, n_layers=6,
                                                scan_layers=True))
    shape = InputShape("t", 64, 64, "train")
    full = dryrun.analyze_program(run, shape, "local_step")
    corr = dryrun._corrected_analysis(run, shape, "local_step", False)
    assert corr["depths"] == [1, 2]
    for k in ("flops_per_chip", "hbm_bytes_per_chip",
              "collective_bytes_per_chip"):
        assert corr[k] == pytest.approx(full[k], rel=1e-9), k
    assert corr["io_bytes_per_chip"] == full["io_bytes_per_chip"]
    assert corr["memory"] == full["memory"]


def test_depth_correction_cuts_remat_groups_whole():
    """A scanned, checkpointed 8-layer reduced xLSTM (mlstm / slstm: groups
    of 2, each one checkpoint): the cut builds keep two and three whole
    groups, and their line gives the 8-layer build's counts and peak."""
    run = get_config("xlstm-350m")
    cfg = dataclasses.replace(reduced(run.model, max_seq_len=S), n_layers=8,
                              scan_layers=True, remat=True)
    run = run.replace(model=cfg)
    assert cfg.scan_grouping() == (0, 2, 4)
    shape = InputShape("t", 16, 32, "train")
    full = dryrun.analyze_program(run, shape, "local_step")
    corr = dryrun._corrected_analysis(run, shape, "local_step", False)
    assert corr["depths"] == [4, 6]
    for k in ("flops_per_chip", "hbm_bytes_per_chip",
              "collective_bytes_per_chip", "io_bytes_per_chip"):
        assert corr[k] == pytest.approx(full[k], rel=1e-9), k
    assert corr["memory"] == full["memory"]


def test_remat_adds_one_forward_and_lowers_the_peak():
    """OLMo-1B at full width, 2 layers, one replica of 1 x 4096 tokens, on
    meta: remat "nothing" adds one forward of the layers, less what the
    backward does not read, to the local step's FLOPs (within 1 %), and
    lowers its peak."""
    from repro_torch.models import model as M
    base = get_config("olmo-1b")
    recs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base.model, n_layers=2, remat=remat)
        fns = steps.make_steps(base.replace(model=cfg))
        mW = specs.abstract_params(cfg, n_replicas=1)
        mopt = specs.abstract_opt_state(fns["optimizer"], mW, stacked=True)
        mbatch = {"tokens": torch.empty((1, 1, 4096), dtype=torch.int32,
                                        device="meta")}
        recs[remat] = dryrun.analyze(fns["local_step"],
                                     (mW, mopt, mbatch, LR))[1]
    # one forward of the layers: a forward's FLOPs less its 0-layer part
    fwd = {}
    for n in (0, 2):
        cfg = dataclasses.replace(base.model, n_layers=n, remat=False)
        params = specs.abstract_params(cfg)
        tokens = torch.empty((1, 4096), dtype=torch.int32, device="meta")
        with torch.no_grad():
            fwd[n] = dryrun.analyze(
                lambda p, t, c=cfg: M.forward(p, {"tokens": t}, c),
                (params, tokens))[1]["flops_per_chip"]
    # the recompute stops once it has the last tensor the backward needs,
    # so a layer's last product (the MLP's down projection, 2·T·D·F) is
    # not recomputed, as the reference's recompute drops what its
    # backward does not read
    added = recs[True]["flops_per_chip"] - recs[False]["flops_per_chip"]
    T, D, F = 4096, base.model.d_model, base.model.d_ff
    assert added == pytest.approx(fwd[2] - fwd[0] - 2 * 2 * T * D * F,
                                  rel=1e-2)
    assert added > 0.75 * (fwd[2] - fwd[0])
    assert recs[True]["memory"]["peak_bytes"] < \
        recs[False]["memory"]["peak_bytes"]


# ----------------------------------------------------- the fake 2 x 2 mesh
def test_fake_mesh_collectives_by_group():
    """Data 2 x model 2, reduced OLMo, R = 4 under ``replica_tp``: a local
    step's own collectives are the replicas' gradient norms over the
    model group and the metrics mean over the data group; a sync's are
    the mean bucket over the data group and S_k over the world — as
    ``test_torch_mesh_tp.py`` counts them on gloo.  DTensor's
    collectives run over the model group."""
    run, _ = _olmo_runs()
    fns = steps.make_steps(run)
    mesh = make_dryrun_mesh({"data": 2, "model": 2})
    try:
        programs, whole = dryrun._mesh_programs(
            run, mesh, InputShape("t", S, R * B, "train"), R, ("data",), fns)
        axis_of = dryrun._axis_of(mesh)
        recs = {p: dryrun.analyze(fn, args, n_chips=4, axis_of=axis_of)[1]
                for p, (fn, args) in programs.items()}
        n_local_params = sum(x.numel() for x in
                             tree_leaves(programs["sync_step"][1][0]))
    finally:
        mesh.close()
    n_local = R // 2
    step = recs["local_step"]["collectives"]["c10d_calls"]
    assert [c[2] for c in step] == ["model"] * n_local + ["data"]
    assert all(c[0] == "all-reduce" for c in step)
    assert step[-1][1] <= 4 * 8                     # loss, grad norm
    sync = recs["sync_step"]["collectives"]["c10d_calls"]
    assert sync == [["all-reduce", 4 * n_local_params // n_local, "data"],
                    ["all-reduce", 4, "world"]]
    # the least traffic counts the rank's rows of W (views of the stacked
    # replicas), read and written, not the storage they are cut from
    assert recs["sync_step"]["io_bytes_per_chip"] == 2 * 4 * n_local_params + 4
    by_axis = recs["local_step"]["collectives"]["count_by_axis"]
    assert by_axis["model"] > n_local and by_axis["data"] == 1
    assert whole["einsum"] > 0


@pytest.mark.parametrize("pods", [1, 2])
def test_fsdp_sync_is_the_mesh_backends(pods):
    """An fsdp plan (reduced Mixtral) on a fake (pod,) data 2 x model 2
    mesh syncs through the mesh backend's own all_mean on rank 0's
    blocks: the kernel's mean and its write-back (two calls), the mean
    bucket all-reduced over ``pod`` (over this rank alone with one pod),
    S_k over the world."""
    run = get_config("mixtral-8x22b")
    run = run.replace(model=reduced(run.model, max_seq_len=S))
    assert run.parallelism.plan == "fsdp"
    fns = steps.make_steps(run)
    shape = {"data": 2, "model": 2}
    mesh = make_dryrun_mesh({"pod": 2, **shape} if pods > 1 else shape)
    try:
        rep_axes = ("pod",) if pods > 1 else ()
        programs, _ = dryrun._fsdp_programs(
            run, mesh, InputShape("t", S, 2 * B, "train"), pods, rep_axes,
            fns)
        fn, args = programs["sync_step"]
        _, rec = dryrun.analyze(fn, args, n_chips=mesh.world,
                                axis_of=dryrun._axis_of(mesh))
        block = sum(x.numel() for x in tree_leaves(args[0]))
    finally:
        mesh.close()
    assert rec["kernels"]["mean_and_sqdev"]["calls"] == 2
    assert rec["collectives"]["c10d_calls"] == [
        ["all-reduce", 4 * block, "pod" if pods > 1 else "self"],
        ["all-reduce", 4, "world"]]
    assert rec["io_bytes_per_chip"] == 2 * 4 * block + 4


# each _WORKSPACE op beside an op of the same output that allocates nothing
# inside its kernel
_WORKSPACE_CASES = {
    "_softmax_backward_data": (
        lambda g, y: torch.ops.aten._softmax_backward_data(
            g, y, 1, torch.float32),
        lambda g, y: torch.mul(g, y)),
    "logsumexp": (lambda g, y: torch.logsumexp(g, [1]),
                  lambda g, y: torch.amax(g, 1)),
}


@pytest.mark.parametrize("op", sorted(dryrun._WORKSPACE))
def test_workspace_op_raises_the_peak_by_its_first_argument(op):
    """CostMode's peak for a ``_WORKSPACE`` op is the plain op's (same
    output) and exactly the bytes of its first argument more."""
    def peak(fn):
        with dryrun.CostMode() as mode:
            g = torch.empty(64, 96, device="meta")
            y = torch.empty(64, 96, device="meta")
            fn(g, y)
        return mode
    with_ws, plain = (peak(fn) for fn in _WORKSPACE_CASES[op])
    assert with_ws.bytes_by_op[op] > 0
    assert with_ws.peak - plain.peak == 64 * 96 * 4
