"""The median over the window's iterations of the host time the engine
loop spends outside the programs in its phases (``runtime/engine.py``):
``data`` (the batch), ``keys`` (the PRNG folds), ``readback`` (the loss
and S_k read to the host) and ``observe`` (the strategy's schedule and
the callbacks); rank 0 on several cards."""
from bench import phase_records

LAYER, UNIT, MOVES = "engine", "ms", "train_tokens_per_s"
PHASES = ("data", "keys", "readback", "observe")


def read(run):
    return phase_records.median_per_iteration(run, PHASES, device=False)
