"""The window's iterations over the syncs in it (the engine's history)."""
LAYER, UNIT, MOVES = "strategy", "steps", "train_tokens_per_s"


def read(run):
    return run.steps / run.syncs if run.syncs else None
