"""Tokens every replica trained on in the window's whole iterations, over
the window's time (syncs included)."""
LAYER, UNIT, MOVES = None, "tokens/s", None


def read(run):
    return run.tokens / run.window_s
