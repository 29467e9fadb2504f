"""The QSGD kernels' share of their roofline over the traced quantized
syncs: the frozen bounds of sqnorm, quantize and dequantize over every
replica's delta of every leaf (``yardstick.qsgd_cost``) over the device
time of the kernels so named."""
import math

from bench import yardstick

LAYER, UNIT, MOVES = "qsgd", "%", "train_tokens_per_s"
KERNELS = ("sqnorm_pass", "quantize_kernel")     # dequantize_kernel too


def read(run):
    tr = run.trace
    if tr is None or not tr.programs.get("sync"):
        return None
    device_s = tr.seconds_matching(KERNELS)
    if device_s <= 0:
        return None
    n = run.cell.traffic["replicas"] * sum(math.prod(s)
                                           for s in run.leaf_shapes)
    bound = sum(yardstick.bound_s(*yardstick.qsgd_cost(k, n))
                for k in ("sqnorm", "quantize", "dequantize"))
    return 100.0 * bound * tr.programs["sync"] / device_s
