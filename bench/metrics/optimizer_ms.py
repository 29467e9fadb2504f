"""The median over the window's iterations of one iteration's ``optimizer``
device time (adamw's update and the gradient norm), summed over this
process's replicas (rank 0 on several cards)."""
from bench import phase_records

LAYER, UNIT, MOVES = "local step", "ms", "train_tokens_per_s"


def read(run):
    return phase_records.median_per_iteration(run, ("optimizer",))
