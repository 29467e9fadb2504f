"""The median over the window's iterations of one iteration's ``forward``
device time (the loss, per replica: ``core/averaging.py::value_and_grad``),
summed over this process's replicas (rank 0 on several cards)."""
from bench import phase_records

LAYER, UNIT, MOVES = "local step", "ms", "train_tokens_per_s"


def read(run):
    return phase_records.median_per_iteration(run, ("forward",))
