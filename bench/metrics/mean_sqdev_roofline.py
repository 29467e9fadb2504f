"""The mean + sqdev kernel's share of its roofline over the traced syncs:
the frozen bound of the launch's modes (``yardstick.grouped_cost``: each
input read once, each output written once, at 3.35 TB/s) over the
kernel's device time.  The vmap backend's sync is one launch in mode
"sync" over R stacked replicas; the mesh's a launch in mode "mean" and
one in "sync_to" over the rank's replicas."""
from bench import yardstick

LAYER, UNIT, MOVES = "kernels", "%", "train_tokens_per_s"
MODES = {"vmap": ("sync",), "mesh": ("mean", "sync_to")}


def read(run):
    tr = run.trace
    if tr is None or not tr.programs.get("sync"):
        return None
    device_s = tr.seconds_matching(("mean_sqdev",))
    if device_s <= 0:
        return None
    t = run.cell.traffic
    local = t["replicas"] // (run.chips if t["backend"] == "mesh" else 1)
    shapes = [(local,) + s for s in run.leaf_shapes]
    bound = sum(yardstick.bound_s(*yardstick.grouped_cost(shapes, mode))
                for mode in MODES[t["backend"]])
    return 100.0 * bound * tr.programs["sync"] / device_s
