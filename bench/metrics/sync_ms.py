"""The median span of the plain sync program (the replica mean and S_k)."""
import statistics

LAYER, UNIT, MOVES = "sync", "ms", "train_tokens_per_s"


def read(run):
    ms = [(t1 - t0) * 1e3 for name, _, t0, t1, *_ in run.spans if name == "sync"]
    return statistics.median(ms) if ms else None
