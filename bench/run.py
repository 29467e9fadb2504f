"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's number of
NVIDIA GPUs.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics and the device trace.  A cell on
several cards starts one process per card (this script again, with
``--rank``), with a rendezvous on a free TCP port of 127.0.0.1; rank 0
prints the line.  Exits non-zero, with no line, without enough GPUs, when
any rank fails, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, leads the path (bench/ holds
# modules named like standard ones); then the program's sources
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, chips: int) -> int:
    return launch_script(Path(__file__).resolve(), [
        "--workload", args.workload, "--seed", str(args.seed),
        "--seconds", str(args.seconds), "--trace", str(args.trace),
        "--t0", repr(T_START)], chips)


def launch_script(script: Path, args, chips: int) -> int:
    """``script`` with ``args`` in one process per GPU (each adds
    ``--rank``), all torn down when one fails or this one is ended; the
    job fails when any rank does.  NCCL's shared-memory transport is off
    (it would write files in /dev/shm); its peer-to-peer transport carries
    the traffic."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(chips),
               LOCAL_WORLD_SIZE=str(chips), NCCL_SHM_DISABLE="1",
               OMP_NUM_THREADS="1")
    argv = [sys.executable, str(script), *args]
    procs = []

    def stop_all(*_):
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 30
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def on_signal(signum, _frame):
        stop_all()
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                argv + ["--rank", str(r)],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=None if r == 0 else sys.stderr))
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                print(f"rank {bad[0][0]} exited with {bad[0][1]}; stopping "
                      f"the others", file=sys.stderr)
                return 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        stop_all()


def main(argv=None) -> int:
    args = parse(argv)
    from bench.cells import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA GPU(s); this "
              f"machine shows "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if cell.chips > 1 and args.rank is None:
        return launch(args, cell.chips)
    from bench import runner
    result, notes = runner.run(cell, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace),
                               t_start=args.t0 or T_START,
                               rank=args.rank or 0)
    if result is None:                 # a rank other than 0
        return 0
    found = forbidden_modules()
    if found:
        print(f"loaded in the reporting process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
