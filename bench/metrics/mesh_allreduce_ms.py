"""The median over the window's syncs of rank 0's ``allreduce`` device time
(``backends/mesh.py::_lower_all_mean``): the NCCL all-reduce of the sync's
mean bucket."""
from bench import phase_records

LAYER, UNIT, MOVES = "mesh backend", "ms", "train_tokens_per_s"


def read(run):
    return phase_records.median_per_iteration(run, ("allreduce",))
