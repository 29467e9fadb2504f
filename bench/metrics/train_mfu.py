"""The whole step's share of the chips' bf16 peak: the traced window's
model FLOPs (``yardstick.train_flops_per_sequence``, no recompute) over
its time, 989 TFLOP/s and the chips."""
from bench import yardstick

LAYER, UNIT, MOVES = "local step", "%", "train_tokens_per_s"


def read(run):
    flops = run.flops_per_step * run.steps
    return 100.0 * flops / (run.window_s * yardstick.BF16_FLOPS_PER_S
                            * run.chips)
