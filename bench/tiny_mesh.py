"""A cell on the mesh backend at tiny size on the CPU, in several gloo
processes started as ``run.py`` starts a cell's ranks: the rehearsal of a
multi-card cell's whole run without a card.

    PYTHONPATH=src python3 bench/tiny_mesh.py --workload <cell> \\
        [--fault <name>] [--world 4]
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--traffic", default=None)
    ap.add_argument("--fault", default="")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--limit", type=float, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        from bench import run
        return run.launch_script(Path(__file__).resolve(), sys.argv[1:],
                                 args.world)
    import torch
    from bench import correct, runner
    from bench.faults import FAULTS
    from bench.tiny import tiny_cell
    torch.manual_seed(0)
    cell = tiny_cell(args.workload, args.traffic, compute_dtype="float32",
                     chips=args.world)
    cell.traffic = dict(cell.traffic, replicas=args.world)
    if args.limit is not None:
        cell = dataclasses.replace(cell, limits={
            "limits": dict.fromkeys(correct.NAMES, args.limit)})
    ctx = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
    with ctx:
        result, notes = runner.run(cell, seed=2 ** 31 + 3, seconds=0.0,
                                   trace=False, t_start=T_START,
                                   rank=args.rank, device="cpu",
                                   strict=False)
    if result is not None:
        print("\n".join(notes), file=sys.stderr)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
