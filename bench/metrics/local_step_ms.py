"""The median span of the local-step program (``engine.strategy.programs``
"step"), each ending in a synchronize."""
import statistics

LAYER, UNIT, MOVES = "local step", "ms", "train_tokens_per_s"


def read(run):
    ms = [(t1 - t0) * 1e3 for name, _, t0, t1, *_ in run.spans if name == "step"]
    return statistics.median(ms) if ms else None
