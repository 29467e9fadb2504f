#!/usr/bin/env python3
"""How long ``load_checkpoint`` takes to read a training checkpoint, for the
checkpoint reader of any checkout.

    python3 scripts/ckpt_read_time.py [--layers 4] [--replicas 4]
        [--device cpu] [--repeats 2] [ROOT ...]

Writes one checkpoint with this checkout's ``save_checkpoint``: OLMo-1B at
its published width cut to ``--layers`` layers, stacked over
``--replicas`` replicas, with its adamw state (the tree ``chip_smoke.py``'s
phase 9 saves: 5.94 GB of parameters and 11.89 GB of optimizer state at 4
layers and R = 4).  Then, for each ROOT in the order given (a checkout of
this repository; default: this one; name a ROOT twice to interleave, e.g.
``A B B A``), a process of its own imports that checkout's
``repro_torch.checkpoint.io`` and times ``load_checkpoint`` onto
``--device`` ``--repeats`` times.  The file was just written, so its reads
are warm (the page cache holds it).  Prints each time, the card's
``nvidia-smi`` name and power limit where there is one and, last, one
JSON object by ROOT.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def write(path: str, layers: int, replicas: int) -> int:
    """Save the checkpoint with this checkout's writer; its bytes."""
    import dataclasses

    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import abstract_opt_state, abstract_params
    from repro_torch.optim.optimizers import adamw

    cfg = dataclasses.replace(get_config("olmo-1b").model, n_layers=layers)
    params = abstract_params(cfg, replicas)
    opt = abstract_opt_state(adamw(), params, stacked=True)

    def real(tree):
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(real(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return torch.zeros(tree.shape, dtype=tree.dtype)
        return tree

    save_checkpoint(path, real(params), opt_state=real(opt), step=1)
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


def one(path: str, device: str, repeats: int) -> list:
    """``load_checkpoint``'s seconds onto ``device`` (this process's
    ``repro_torch``), ``repeats`` times."""
    import torch
    from repro_torch.checkpoint.io import load_checkpoint
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        got = load_checkpoint(path, device)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del got
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.device, args.repeats)))
        return 0
    tmp = tempfile.mkdtemp(prefix="ckpt_read_time_")
    try:
        t0 = time.perf_counter()
        nbytes = write(tmp, args.layers, args.replicas)
        print(f"wrote {nbytes} B in {time.perf_counter() - t0:.3f} s")
        out = {}
        for root in args.roots:
            env = dict(os.environ,
                       PYTHONPATH=str(Path(root).resolve() / "src"))
            run = subprocess.run(
                [sys.executable, __file__, "--one", tmp, "--device",
                 args.device, "--repeats", str(args.repeats)],
                env=env, capture_output=True, text=True, check=True)
            times = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"{root}: load_checkpoint onto {args.device} "
                  + " ".join(f"{t:.3f}" for t in times) + " s")
            out.setdefault(root, []).extend(times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    except (OSError, subprocess.CalledProcessError, IndexError):
        print("no nvidia-smi")
    print(json.dumps({"bytes": nbytes, "device": args.device,
                      "seconds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
