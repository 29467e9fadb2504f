"""The CUDA kernels (mean_and_sqdev; QSGD's sqnorm, quantize and
dequantize; flash attention) against their plain versions, on the card;
and the programs around them that only the card can check (DaSGD's
snapshot in stream order, the WallClock waiting for the device).

Imports neither jax nor the reference, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_kernels_cuda.py

Without a CUDA device every case skips (the kernels have no CPU mode).
Tolerances: mean atol 1e-6, sq and sqnorm rtol 1e-5 (f32 sums in another
order); the grouped mean_and_sqdev's means and deltas bitwise (the replicas
summed in index order, as the plain version does); levels and dequantized values bit-identical given the same norm
and uniforms; a tensor's sqnorm in a group bit-identical to its sqnorm
alone; flash attention atol = rtol = 2e-5 in f32 and 2e-2 in bf16, the
tolerances of the reference's kernel test (online against exact softmax;
one bf16 rounding of the output)."""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import qsgd_quant
from repro_torch.kernels import ref as torch_ref
from repro_torch.kernels.param_variance import mean_and_sqdev

CASES = [(2, (100,)), (8, (33, 7)), (16, (1024,)), (4, (5, 4, 3)),
         (4, (2048, 2048))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,shape", CASES)
def test_kernel_matches_plain_and_repeats_bitwise(cuda, R, shape):
    w = torch.from_numpy(
        np.random.RandomState(R).randn(R, *shape).astype(np.float32)).to(cuda)
    before = mean_and_sqdev.launches
    m, sq = mean_and_sqdev(w)
    m2, sq2 = mean_and_sqdev(w)
    torch.cuda.synchronize()
    assert mean_and_sqdev.launches == before + 2
    m_ref, sq_ref = torch_ref.mean_and_sqdev_ref(w)
    torch.testing.assert_close(m, m_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(m, m2) and torch.equal(sq, sq2)


# each distinct leaf shape of DeepSeek-V2-Lite's training path (R = 4) that
# OLMo's have not: the experts, the router, MLA's projections and norm, the
# shared experts, layer 0's dense MLP, the norms, the embedding and the head
DEEPSEEK_LEAF_SHAPES = [(64, 2048, 1408), (64, 1408, 2048), (2048, 64),
                        (2048, 3072), (2048, 576), (512, 4096), (512,),
                        (2048, 2816), (2816, 2048), (2048, 10944),
                        (10944, 2048), (2048,), (102400, 2048),
                        (2048, 102400)]


# each distinct leaf shape of Qwen2-VL-2B's and Whisper-medium's training
# paths (R = 4) that OLMo's and DeepSeek's have not: the embeddings, the
# attention projections (Qwen2-VL's two KV heads: 256 wide), the MLPs, the
# QKV and GELU biases, the norms
VLM_AUDIO_LEAF_SHAPES = [(151936, 1536), (1536, 1536), (1536, 256),
                         (1536, 8960), (8960, 1536), (256,), (1536,),
                         (51865, 1024), (1024, 1024), (1024, 4096),
                         (4096, 1024), (4096,), (1024,)]

# each distinct leaf shape of xLSTM-350M's training path that the lists
# above have not (the mLSTM's gate biases, norm, conv, projections and
# gates, the sLSTM's recurrence and feed-forward), then Jamba's Mamba
# block's (A_log, conv, dt_proj, x_proj, D)
SSM_LEAF_SHAPES = [(4,), (2048,), (4, 2048), (2048, 2048), (4, 256, 1024),
                   (1024, 1344), (1344, 1024), (2048, 8), (2048, 1024),
                   (16384, 16), (4, 16384), (512, 16384), (16384, 544),
                   (16384,)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEEPSEEK_LEAF_SHAPES)
def test_kernel_at_deepseek_leaf_shapes(cuda, shape):
    """R = 4, drawn on the card.  sq rtol 1e-5, or 1e-4 past 1e8 elements
    a replica (the order of summation over 4e8 terms and more differs)."""
    _check_leaf(cuda, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VLM_AUDIO_LEAF_SHAPES)
def test_kernel_at_vlm_audio_leaf_shapes(cuda, shape):
    """As at DeepSeek's leaf shapes."""
    _check_leaf(cuda, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSM_LEAF_SHAPES)
def test_kernel_at_ssm_leaf_shapes(cuda, shape):
    """As at DeepSeek's leaf shapes."""
    _check_leaf(cuda, shape)


def _check_leaf(cuda, shape):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(shape) * 7 + shape[0])
    w = torch.randn((4, *shape), generator=gen, device=cuda)
    m, sq = mean_and_sqdev(w)
    m2, sq2 = mean_and_sqdev(w)
    m_ref, sq_ref = torch_ref.mean_and_sqdev_ref(w)
    torch.cuda.synchronize()
    torch.testing.assert_close(m, m_ref, atol=1e-6, rtol=0)
    tol = 1e-4 if np.prod(shape) > 1e8 else 1e-5
    torch.testing.assert_close(sq, sq_ref, rtol=tol, atol=0)
    assert torch.equal(m, m2) and torch.equal(sq, sq2)


@pytest.mark.cuda
def test_kernel_rejects_strided_input(cuda):
    w = torch.zeros(8, 4, device=cuda).T
    with pytest.raises(ValueError, match="contiguous"):
        mean_and_sqdev(w)


@pytest.mark.cuda
def test_sync_uses_kernel_on_cuda(cuda):
    """One launch of the grouped kernel covers both leaves."""
    from repro_torch.backends import VmapBackend
    W = {"a": torch.randn(4, 300, device=cuda), "n": {},
         "b": [torch.randn(4, 7, 5, device=cuda)]}
    want = float(sum(torch_ref.mean_and_sqdev_ref(x)[1]
                     for x in (W["a"], W["b"][0])) / 4)
    before = (mean_and_sqdev.launches, mean_and_sqdev.leaves)
    W, _, s_k = VmapBackend(device=cuda).all_mean()(W, None)
    assert (mean_and_sqdev.launches, mean_and_sqdev.leaves) == \
        (before[0] + 1, before[1] + 2)
    assert abs(float(s_k) - want) <= 1e-5 * want
    assert torch.equal(W["a"], W["a"][:1].expand_as(W["a"]))


def _tree_on(cuda, shapes, R, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return [torch.randn((R, *s), generator=gen, device=cuda) for s in shapes]


def _check_many(cuda, shapes, R, mode, seed):
    """The grouped kernel in ``mode`` against the plain per-leaf route:
    means (every row after the sync) and deltas bitwise; W unchanged by
    mean and delta; each leaf's sq within rtol 1e-5 (1e-4 past 1e8
    elements a replica), S_k within 1e-5; a bitwise repeat; one launch."""
    from repro_torch.kernels import param_variance as pv
    base = _tree_on(cuda, shapes, R, seed)
    want_sq, want_s_k = torch_ref.mean_and_sqdev_many_ref(
        [x.clone() for x in base], "sync")
    means = [torch_ref.mean_and_sqdev_ref(x)[0] for x in base]
    # the sync writes its leaves; mean and delta only read theirs
    keep = [x.clone() for x in base]
    runs = []
    for _ in range(2):
        leaves = [x.clone() for x in keep] if mode == "sync" else base
        out = None if mode == "sync" else pv.new_out(leaves, mode)
        before = (mean_and_sqdev.launches, mean_and_sqdev.leaves)
        sq, s_k = pv.mean_and_sqdev_many(leaves, mode, out)
        assert (mean_and_sqdev.launches, mean_and_sqdev.leaves) == \
            (before[0] + 1, before[1] + len(leaves))
        runs.append((leaves, out, sq, s_k))
    torch.cuda.synchronize()
    (leaves, out, sq, s_k), (leaves2, out2, sq2, s_k2) = runs
    assert torch.equal(sq, sq2) and torch.equal(s_k, s_k2)
    assert all(torch.equal(a, b) for a, b in zip(leaves, leaves2))
    views = None if out is None else pv.out_views(out, leaves, mode)
    if out is not None:        # the views: out's 16-byte padding is not written
        assert all(torch.equal(a, b) for a, b in
                   zip(views, pv.out_views(out2, leaves, mode)))
    del runs, leaves2, out2
    for i, (x, k, m) in enumerate(zip(leaves, keep, means)):
        if mode == "sync":
            assert torch.equal(x, m.unsqueeze(0).expand_as(x))
            continue
        assert torch.equal(x, k)
        assert torch.equal(views[i], m if mode == "mean"
                           else m.unsqueeze(0) - k)
    tol = torch.tensor([1e-4 if np.prod(s) > 1e8 else 1e-5 for s in shapes],
                       device=cuda)
    assert bool(((sq - want_sq).abs() <= tol * want_sq).all())
    torch.testing.assert_close(s_k, want_s_k, rtol=1e-5, atol=0)


def _check_given(cuda, shapes, R, mode, given, seed):
    """The grouped kernel in "sync_to" or "delta_to", given the plain
    means (divisor 1) or the plain sums over the rows in index order
    (divisor R, as the mesh's all-reduced sum over its world): bitwise
    what "sync" or "delta" write (the means into every row; mean − w,
    here over the leaves themselves, as the mesh's DaSGD snapshot writes
    it), each leaf's sq within rtol 1e-5 of the plain one (1e-4 past 1e8
    elements a replica), S_k within 1e-5, bitwise repeatable, one
    launch."""
    from repro_torch.kernels import param_variance as pv
    base = _tree_on(cuda, shapes, R, seed)
    means = [torch_ref.mean_and_sqdev_ref(x)[0] for x in base]
    want_sq, want_s_k = torch_ref.mean_and_sqdev_many_ref(
        [x.clone() for x in base], "sync")
    mean = pv.new_out(base, "mean")
    for v, m, x in zip(pv.out_views(mean, base, "mean"), means, base):
        if given == "mean":
            v.copy_(m)
        else:
            v.copy_(x[0])
            for r in range(1, R):
                v.add_(x[r])
    divisor = 1 if given == "mean" else R
    runs = []
    for _ in range(2):
        if mode == "sync_to":
            leaves, out = [x.clone() for x in base], None
        else:
            out = pv.new_out(base, mode)
            leaves = pv.out_views(out, base, mode)
            for v, x in zip(leaves, base):
                v.copy_(x)
        before = mean_and_sqdev.launches
        sq, s_k = pv.mean_and_sqdev_many(leaves, mode, out, mean, divisor)
        assert mean_and_sqdev.launches == before + 1
        runs.append((leaves, sq, s_k))
    torch.cuda.synchronize()
    (leaves, sq, s_k), (leaves2, sq2, s_k2) = runs
    assert torch.equal(sq, sq2) and torch.equal(s_k, s_k2)
    for x, x2, b, m in zip(leaves, leaves2, base, means):
        assert torch.equal(x, x2)
        want = (m.unsqueeze(0).expand_as(b) if mode == "sync_to"
                else m.unsqueeze(0) - b)
        assert torch.equal(x, want)
    tol = torch.tensor([1e-4 if np.prod(s) > 1e8 else 1e-5 for s in shapes],
                       device=cuda)
    assert bool(((sq - want_sq).abs() <= tol * want_sq).all())
    torch.testing.assert_close(s_k, want_s_k, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["mean", "sum"])
@pytest.mark.parametrize("mode", ["sync_to", "delta_to"])
@pytest.mark.parametrize("R,shape", CASES)
def test_grouped_kernel_given_mean_at_each_case(cuda, R, shape, mode, given):
    _check_given(cuda, [shape], R, mode, given, seed=R)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["mean", "sum"])
@pytest.mark.parametrize("mode", ["sync_to", "delta_to"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 16])
def test_grouped_kernel_given_mean_on_a_tree(cuda, R, mode, given):
    shapes = [s for _, s in CASES[:4]] + [(), (7,), (2048 * 3 + 5,), (1,)]
    _check_given(cuda, shapes, R, mode, given, seed=20 + R)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mean", "sync", "delta"])
@pytest.mark.parametrize("R,shape", CASES)
def test_grouped_kernel_at_each_case(cuda, R, shape, mode):
    _check_many(cuda, [shape], R, mode, seed=R)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mean", "sync", "delta"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 16])
def test_grouped_kernel_on_a_tree_of_the_cases(cuda, R, mode):
    """Every R the kernel specialises and two it does not, over one tree of
    the case shapes and a few ragged and 1-element leaves."""
    shapes = [s for _, s in CASES[:4]] + [(), (7,), (2048 * 3 + 5,), (1,)]
    _check_many(cuda, shapes, R, mode, seed=10 + R)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mean", "sync", "delta"])
@pytest.mark.parametrize("family,R", [("deepseek", 4), ("vlm_audio", 4),
                                      ("ssm", 2), ("ssm", 4)])
def test_grouped_kernel_at_the_families_leaf_shapes(cuda, family, R, mode):
    """R = 4 over DeepSeek-V2-Lite's leaf shapes, then Qwen2-VL-2B's and
    Whisper-medium's, each list as one tree; xLSTM-350M's and Jamba's at R
    = 2 (Jamba's training path) and 4 (xLSTM's)."""
    shapes = {"deepseek": DEEPSEEK_LEAF_SHAPES,
              "vlm_audio": VLM_AUDIO_LEAF_SHAPES,
              "ssm": SSM_LEAF_SHAPES}[family]
    _check_many(cuda, shapes, R, mode, seed=len(shapes))
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_grouped_table_is_cached_per_tree(cuda):
    """The device table of a tree is built once and reused while its
    buffers stay; fresh buffers of the same shapes get their own."""
    from repro_torch.kernels import param_variance as pv
    W = _tree_on(cuda, [(300,), (7, 5)], 4, 5)
    _, s1 = pv.mean_and_sqdev_many(W, "sync")
    entry = pv._device_table(W)
    _, s2 = pv.mean_and_sqdev_many(W, "sync")
    assert pv._device_table(W) is entry
    assert float(s2) < 1e-10 < float(s1)     # the first sync averaged W
    fresh = [x.clone() + torch.arange(4, device=cuda).view(4, *[1] * (x.dim() - 1))
             for x in W]
    _, s3 = pv.mean_and_sqdev_many(fresh, "sync")
    assert pv._device_table(fresh) is not entry
    assert torch.equal(fresh[0], fresh[0][:1].expand_as(fresh[0]))
    assert abs(float(s3) - (300 + 35) * 5 / 4) <= 1e-4 * float(s3)


QSGD_CASES = [(7,), (1000,), (1024,), (4097,), (33, 17), (2048, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QSGD_CASES)
@pytest.mark.parametrize("bits", [4, 8])
def test_qsgd_kernels_match_plain(cuda, shape, bits):
    rng = np.random.RandomState(len(shape) * 1000 + shape[0])
    x = torch.from_numpy((rng.randn(*shape) * 3.0).astype(np.float32)).to(cuda)
    u = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(cuda)
    before = (qsgd_quant.sqnorm.launches, qsgd_quant.quantize.launches,
              qsgd_quant.dequantize.launches)
    sq, sq2 = qsgd_quant.sqnorm(x), qsgd_quant.sqnorm(x)
    norm = torch.sqrt(sq)
    lv = qsgd_quant.quantize(x, u, norm, bits)
    dq = qsgd_quant.dequantize(lv, norm, bits)
    torch.cuda.synchronize()
    assert (qsgd_quant.sqnorm.launches, qsgd_quant.quantize.launches,
            qsgd_quant.dequantize.launches) == (before[0] + 2, before[1] + 1,
                                                before[2] + 1)
    torch.testing.assert_close(sq, torch_ref.sqnorm_ref(x), rtol=1e-5, atol=0)
    assert torch.equal(sq, sq2)
    lv_ref, _ = torch_ref.quantize_ref(x, u, bits, norm=norm)
    assert lv.dtype == torch.int8 and torch.equal(lv, lv_ref)
    assert torch.equal(dq, torch_ref.dequantize_ref(lv, norm, bits))
    s = (1 << (bits - 1)) - 1
    assert float((dq - x).abs().max()) <= float(norm) / s * (1 + 1e-6)


@pytest.mark.cuda
def test_qsgd_kernels_zero_and_saturation(cuda):
    z = torch.zeros(128, device=cuda)
    norm = torch.sqrt(qsgd_quant.sqnorm(z))
    lv = qsgd_quant.quantize(z, z, norm)
    assert float(norm) == 0.0 and not lv.any()
    assert not qsgd_quant.dequantize(lv, norm).any()
    x = torch.tensor([1.5, -1.5, 0.25], device=cuda)
    near = torch.tensor(1.5 * (1 - 2**-20), device=cuda)
    lv = qsgd_quant.quantize(x, torch.zeros(3, device=cuda), near)
    assert lv.tolist()[:2] == [127, -128]
    assert torch.equal(lv, torch_ref.quantize_ref(
        x, torch.zeros(3, device=cuda), 8, norm=near)[0])


@pytest.mark.cuda
def test_uniform_on_card_equals_cpu(cuda):
    key = prng.split(prng.fold_in(prng.prng_key(17), 3), 4)[2]
    shape = (257, 1031)
    assert torch.equal(prng.uniform(key, shape, device=cuda).cpu(),
                       prng.uniform(key, shape, device="cpu"))


@pytest.mark.cuda
def test_quantized_sync_uses_kernels_on_cuda(cuda):
    from repro_torch.backends import VmapBackend
    g = torch.Generator().manual_seed(0)
    W = {"a": torch.randn(4, 300, generator=g), "n": {},
         "b": [torch.randn(4, 7, 5, generator=g)]}
    anchor = {"a": W["a"].mean(0), "n": {}, "b": [W["b"][0].mean(0)]}
    key = prng.fold_in(prng.prng_key(17), 1)

    def run(device, use_kernel):
        mv = lambda t: {"a": t["a"].to(device), "n": {},
                        "b": [t["b"][0].to(device)]}
        return VmapBackend(use_kernel=use_kernel, device=device) \
            .quantized_all_mean(8)(mv(W), mv(anchor), key)

    before = (mean_and_sqdev.launches, qsgd_quant.sqnorm.launches,
              qsgd_quant.quantize.launches)
    Wk, ak, sk = run(cuda, None)
    assert (mean_and_sqdev.launches, qsgd_quant.sqnorm.launches,
            qsgd_quant.quantize.launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 2 * 4)
    Wp, ap, sp = run(cuda, False)
    assert abs(float(sk) - float(sp)) <= 1e-5 * abs(float(sp))
    torch.testing.assert_close(Wk["a"], Wp["a"], rtol=1e-6, atol=1e-6)
    assert torch.equal(Wk["a"], Wk["a"][:1].expand_as(Wk["a"]))


@pytest.mark.cuda
def test_mean_delta_uses_kernel_and_stream_order_on_cuda(cuda):
    """DaSGD's snapshot: one mean_and_sqdev launch over both leaves; the
    delta is mean − w_i; the work is queued on W's stream, so an in-place
    write to W right after the dispatch (the next local step) does not
    reach the fetched delta; apply_delta adds it in place; S_k as the
    plain version's (rtol 1e-5)."""
    from repro_torch.backends import VmapBackend
    g = torch.Generator().manual_seed(3)
    W = {"a": torch.randn(4, 300, generator=g).to(cuda), "n": {},
         "b": [torch.randn(4, 7, 5, generator=g).to(cuda)]}
    old = {"a": W["a"].clone(), "b": W["b"][0].clone()}
    backend = VmapBackend(device=cuda)
    before = (mean_and_sqdev.launches, mean_and_sqdev.leaves)
    inflight = backend.mean_delta(overlap=True)(W)
    W["a"].add_(100.0)                        # the next step, in place
    W["b"][0].mul_(-3.0)
    delta, s_k = inflight.fetch()
    assert (mean_and_sqdev.launches, mean_and_sqdev.leaves) == \
        (before[0] + 1, before[1] + 2)
    want = float(sum(torch_ref.mean_and_sqdev_ref(x)[1]
                     for x in old.values()) / 4)
    assert abs(float(s_k) - want) <= 1e-5 * want
    torch.testing.assert_close(delta["a"], old["a"].mean(0) - old["a"],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(delta["b"][0],
                               old["b"].mean(0) - old["b"], rtol=0, atol=1e-6)
    ptr = W["a"].data_ptr()
    W = backend.apply_delta()(W, delta)
    assert W["a"].data_ptr() == ptr
    torch.testing.assert_close(W["a"], old["a"] + 100.0
                               + (old["a"].mean(0) - old["a"]),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_inner_mean_on_cuda(cuda):
    from repro_torch.backends import VmapBackend
    g = torch.Generator().manual_seed(4)
    W = {"a": torch.randn(4, 3, 5, generator=g).to(cuda),
         "b": [torch.randn(4, 11, generator=g).to(cuda)]}
    want = W["a"].view(2, 2, 3, 5).mean(1)
    W = VmapBackend(device=cuda).inner_mean(2)(W)
    for x in (W["a"], W["b"][0]):
        assert torch.equal(x[0], x[1]) and torch.equal(x[2], x[3])
        assert not torch.equal(x[0], x[2])
    torch.testing.assert_close(W["a"][::2], want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_wallclock_waits_for_the_card(cuda):
    """A WallClock record of a CUDA program covers the program's device
    time: at least the time of a known ``torch.cuda._sleep``, timed by
    CUDA events.  The SimulatedClock returns while the sleep still runs."""
    from repro_torch.runtime.clock import SimulatedClock, WallClock
    cycles = 100_000_000
    x = torch.zeros(4, device=cuda)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3

    def program(x):
        torch.cuda._sleep(cycles)
        return {"s_k": x + 1}

    clock = WallClock()
    clock.measure("all_mean", program, (x,), is_step=False)
    rec = clock.timeline.last
    assert clock.n_blocks == 1 and rec.compute_s == 0.0
    assert rec.comm_s >= 0.99 * sleep_s > 0.005
    sim = SimulatedClock("10gbps")
    sim.measure("replica_step", program, (x,), is_step=True)
    assert not torch.cuda.current_stream(cuda).query()
    torch.cuda.synchronize()
    assert sim.timeline.last.compute_s == 5e-3


def _sqnorm_group(sizes, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(n) * 3.0).astype(np.float32))
            .to("cuda") for n in sizes]


# one tensor each; 29 mixed leaves (an embedding-like leaf among 2-d
# matrices and small vectors); 130 tensors, three launches of up to 64
SQNORM_GROUPS = {"1": [1], "7": [7], "4097": [4097],
                 "embedding": [103_022_592],
                 "29_leaves": [50304 * 64] + [2048 * 64, 64 * 256, 256 * 64,
                                              64, 7] * 4 + [4097] * 4,
                 "130_tensors": list(range(1, 131))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SQNORM_GROUPS))
def test_sqnorm_many_matches_plain_and_single(cuda, name):
    sizes = SQNORM_GROUPS[name]
    xs = _sqnorm_group(sizes, len(sizes))
    before = qsgd_quant.sqnorm.launches
    sq = qsgd_quant.sqnorm_many(xs)
    sq2 = qsgd_quant.sqnorm_many(xs)
    torch.cuda.synchronize()
    launches = -(-len(xs) // qsgd_quant.MAX_GROUP)
    assert qsgd_quant.sqnorm.launches == before + 2 * launches
    assert sq.shape == (len(xs),) and sq.dtype == torch.float32
    torch.testing.assert_close(sq, torch_ref.sqnorm_many_ref(xs), rtol=1e-5,
                               atol=0)
    assert torch.equal(sq, sq2)
    alone = torch.stack([qsgd_quant.sqnorm(x) for x in xs])
    assert torch.equal(sq, alone)


@pytest.mark.cuda
def test_sqnorm_many_refuses_mixed_devices(cuda):
    with pytest.raises(ValueError, match="one device"):
        qsgd_quant.sqnorm_many([torch.ones(4, device=cuda), torch.ones(4)])


# (B, Sq, Sk, H, K, d): the reference's test shapes and S = 100; then, at
# every head dim (bf16: the SIMT instance at 32, the wgmma instance at 64
# and 128), one 128 x 128 tile, several 128-row tiles (S = 640), S = 100,
# Sq != Sk (ragged Sk too) and GLM4's 16:1 GQA.
FLASH_CASES = ([(1, 128, 128, 4, 4, 64), (2, 256, 256, 4, 2, 32),
                (1, 384, 384, 6, 3, 128), (2, 128, 128, 8, 1, 64),
                (1, 100, 100, 4, 2, 128)]
               + [c for d in (32, 64, 128)
                  for c in ((1, 128, 128, 1, 1, d), (1, 640, 640, 4, 2, d),
                            (1, 100, 100, 4, 2, d), (1, 128, 384, 4, 2, d),
                            (1, 256, 100, 4, 2, d), (1, 256, 256, 32, 2, d))])


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,K,d", FLASH_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 200), (False, 0),
                                           (False, 64)])
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, H, K, d, dtype, tol,
                                       causal, window):
    rng = np.random.RandomState(Sq * H + Sk + window)
    q = torch.from_numpy(rng.randn(B, Sq, H, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, Sk, K, d).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    want = torch_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == (B, Sq, H, d)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(out, again)


# (B, S, H, K, d) of one prefill layer of each dense config served:
# MiniCPM-2B (MHA, d 64), GLM4-9B (16:1 GQA) and Qwen2.5-14B (5:1 GQA);
# then Qwen2-VL-2B (6:1 GQA, 64 patches + 1984 tokens), Whisper-medium's
# decoder (MHA at d 64, batch 4) and Jamba's attention layer (8:1 GQA, 64
# heads)
DENSE_PREFILL = [(1, 2048, 36, 36, 64), (1, 2048, 32, 2, 128),
                 (1, 2048, 40, 8, 128), (1, 2048, 12, 2, 128),
                 (4, 512, 16, 16, 64), (1, 2048, 64, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,d", DENSE_PREFILL)
def test_flash_attention_dense_prefill_layers(cuda, B, S, H, K, d):
    """bf16, causal, at the prefill layers of the served configs, against
    the plain version (atol = rtol = 2e-2) and bitwise repeated."""
    g = torch.Generator(device=cuda).manual_seed(H * d + K)
    q = torch.randn(B, S, H, d, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(B, S, K, d, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    want = torch_ref.attention_ref(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_flash_attention_refuses_on_the_card(cuda):
    q = torch.zeros(1, 200, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 128, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention(q, q, q)
