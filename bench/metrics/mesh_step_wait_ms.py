"""The median over the window's iterations of rank 0's ``metrics_allreduce``
device time (``backends/mesh.py::_metrics_mean``): the step's small
all-reduce, where a rank waits for the slowest, plus a few scalars'
transfer."""
from bench import phase_records

LAYER, UNIT, MOVES = "mesh backend", "ms", "train_tokens_per_s"


def read(run):
    return phase_records.median_per_iteration(run, ("metrics_allreduce",))
