"""The median span of the quantized sync (threefry uniforms, sqnorm,
quantize, dequantize and the mean of the deltas, per leaf)."""
import statistics

LAYER, UNIT, MOVES = "qsgd", "ms", "train_tokens_per_s"


def read(run):
    ms = [(t1 - t0) * 1e3 for name, _, t0, t1, *_ in run.spans if name == "sync"]
    return statistics.median(ms) if ms else None
