"""The traced window less the union of device kernel intervals, as a share
of it (``torch.profiler``, rank 0 on several cards)."""
LAYER, UNIT, MOVES = "device", "%", "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
