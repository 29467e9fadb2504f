"""The median span of rank 0's sync program on the mesh: the chunk mean,
the NCCL all-reduce of the flat mean, ``sync_to`` and the S_k
all-reduce."""
import statistics

LAYER, UNIT, MOVES = "mesh backend", "ms", "train_tokens_per_s"


def read(run):
    ms = [(t1 - t0) * 1e3 for name, _, t0, t1, *_ in run.spans if name == "sync"]
    return statistics.median(ms) if ms else None
