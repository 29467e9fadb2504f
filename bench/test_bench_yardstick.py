"""The frozen arithmetic: FLOPs of both configurations by hand, the byte
bounds by their formulas, the categories."""
import math

import pytest

from bench import yardstick as y
from bench.cells import load_json


def test_olmo_flops_by_hand():
    c = load_json("configs", "olmo-1b")
    D, F, V, L, S = 2048, 8192, 50304, 16, 2048
    macs = L * (4 * D * D + 3 * D * F) + D * V
    assert y.matmul_macs_per_token(c) == macs == 1_176_764_416
    attn = L * 4 * 128 * 16 * (S * (S + 1) // 2)
    assert y.train_flops_per_sequence(c, S) == 3 * (2 * macs * S + attn)
    # 8,192 tokens a step: 6.11e13 FLOPs
    assert y.train_flops_per_sequence(c, S) * 4 == pytest.approx(6.114e13,
                                                                 rel=1e-3)


def test_deepseek_flops_by_hand():
    c = load_json("configs", "deepseek-v2-lite")
    D, H, S = 2048, 16, 2048
    mla = D * H * 192 + D * 576 + 512 * H * 256 + H * 128 * D
    dense = 3 * D * 10944
    moe = D * 64 + 3 * D * 1408 * 2 + 3 * D * 1408 * 6
    head = D * 102400
    macs = 2 * mla + dense + moe + head
    assert y.matmul_macs_per_token(c) == macs
    attn = 2 * 2 * (192 + 128) * H * (S * (S + 1) // 2)
    assert y.train_flops_per_sequence(c, S) == 3 * (2 * macs * S + attn)


def test_causal_pairs_by_count():
    for s in (1, 2, 7, 64):
        assert y.causal_pairs(s) == sum(i + 1 for i in range(s))


def test_byte_bounds():
    shapes = [(4, 3, 5), (4, 7)]
    n_in, n_out = 4 * 15 + 4 * 7, 15 + 7
    assert y.grouped_cost(shapes, "mean") == ((n_in + n_out) * 4, 4 * n_in)
    assert y.grouped_cost(shapes, "sync") == (8 * n_in, 4 * n_in)
    assert y.grouped_cost(shapes, "sync_to") == (8 * n_in + 4 * n_out,
                                                 4 * n_in)
    n = 1000
    assert y.qsgd_cost("sqnorm", n) == (4 * n, 2 * n)
    assert y.qsgd_cost("quantize", n) == (9 * n, 8 * n)
    assert y.qsgd_cost("dequantize", n) == (5 * n, n)
    assert y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert y.bound_s(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,cat", [
    ("mean_sqdev_tiles", "mean_sqdev"), ("sqnorm_pass1", "qsgd kernels"),
    ("dequantize_kernel", "qsgd kernels"), ("nvjet_tst_128x256", "matmul"),
    ("void at::native::vectorized_elementwise_kernel", "elementwise"),
    ("something_else", "other")])
def test_categories(name, cat):
    assert y.category(name) == cat


def test_leaf_bound_of_olmo_sync():
    # one sync of 4 OLMo replicas moves 8 bytes an element
    n = 1_176_764_416
    b, _ = y.grouped_cost([(4, n)], "sync")
    assert y.bound_s(b, 0) * 1e3 == pytest.approx(8 * 4 * n / 3.35e9)
    assert math.isclose(b, 32 * n)
