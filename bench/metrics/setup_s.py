"""Process start to the window's start: imports, inputs, the engine,
kernel builds (a checkout's first run) and the warm-up iterations."""
LAYER, UNIT, MOVES = None, "s", None


def read(run):
    return run.setup_s
