"""``torch.cuda.max_memory_allocated()`` over set-up and window, the
largest over the ranks, in GiB."""
LAYER, UNIT, MOVES = None, "GiB", None


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
