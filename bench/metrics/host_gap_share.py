"""The share of the traced run's window that lies in no program span: the
engine's Python, the data function and the per-step loss readback."""
LAYER, UNIT, MOVES = "engine", "%", "train_tokens_per_s"


def read(run):
    if not run.spans:
        return None
    inside = sum(t1 - t0 for _, _, t0, t1, *_ in run.spans)
    return 100.0 * (1.0 - inside / run.window_s)
