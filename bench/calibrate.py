"""The readings the correctness limits are set from, on the card, at a
cell's own sizes (not run by the benchmark's runs):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults half_batch,no_exchange] [--out F]

For each seed, in one process: the program's first three iterations
against the f32 reference (a sound run); for each ``--control`` seed, the
reference computed in fp8 (``reference/model.py``) in the program's
place, against the f32 reference; for each fault (``faults.py``) and
control seed, the program with the fault planted.  Prints and appends one
JSON line per reading.  A cell on several cards runs its ranks as
``run.py`` does.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None)
    return ap.parse_args(argv)


def ints(s):
    return [int(x) for x in s.split(",") if x]


def calibrate(cell, seeds, controls, faults, device, rank=0, emit=print):
    """The readings of ``seeds`` (sound runs), and for the seeds in
    ``controls`` the fp8 control's and each fault's; ``emit`` takes one
    record a reading (on rank 0)."""
    import contextlib

    import torch
    from bench import correct, harness, runner
    from bench.faults import FAULTS
    from bench.reference import train as reference
    mesh = cell.traffic["backend"] == "mesh"
    if mesh:
        # one process group for every seed: each engine's mesh joins it
        # (a group destroyed and made again on the same port can hang)
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.init_group(torch.device(device), rank=rank,
                            world=cell.chips)

    def program(seed, fault=None):
        ctx = FAULTS[fault]() if fault else contextlib.nullcontext()
        with ctx:
            engine, host, skel, tokens, readings = runner.prepare(
                cell, seed, device)
            harness.free_program(engine)
            parts = ([readings] if not mesh
                     else runner._gather(readings, cell.chips))
            if mesh:
                engine.backend.close()
            del engine
        return runner.program_readings(parts), host, skel, tokens

    def worst_leaves(prog, ref, skel):
        """The leaf of each number's largest gap (path, gap)."""
        keep = [True] * len(ref["grad_norms"][0])
        names = reference.leaf_paths(skel)
        out = {}
        for key in ("grad_norms", "delta_norms"):
            gaps = correct.leaf_gaps(prog[key], ref[key], keep)
            r, i = max(((r, i) for r in range(len(gaps))
                        for i in range(len(gaps[r]))),
                       key=lambda ri: gaps[ri[0]][ri[1]])
            out[key] = [names[i], r, gaps[r][i]]
        return out

    def follow(skel, host, tokens, seed, precision="f32"):
        return reference.follow(cell.config, cell.traffic, skel, host,
                                tokens, seed % harness.ENGINE_SEED_MOD,
                                precision=precision)

    for seed in seeds:
        t0 = time.time()
        prog, host, skel, tokens = program(seed)
        if rank == 0:
            ref = follow(skel, host, tokens, seed)
            emit({"cell": cell.name, "seed": seed, "kind": "sound",
                  **correct.gaps(prog, ref), "losses": prog["losses"],
                  "ref_losses": ref["losses"], "s_k": prog["s_k"],
                  "ref_s_k": ref["s_k"],
                  "worst": worst_leaves(prog, ref, skel),
                  "s": time.time() - t0})
        if seed not in controls:
            continue
        if rank == 0:
            low = follow(skel, host, tokens, seed, "fp8")
            emit({"cell": cell.name, "seed": seed, "kind": "control_fp8",
                  **correct.gaps(low, ref), "s_k": low["s_k"],
                  "worst": worst_leaves(low, ref, skel)})
        for fault in faults:
            prog, *_ = program(seed, fault)
            if rank == 0:
                emit({"cell": cell.name, "seed": seed, "kind": fault,
                      **correct.gaps(prog, ref)})
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if mesh:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from bench.cells import load_cell
    cell = load_cell(args.workload)
    if cell.traffic["backend"] == "mesh" and args.rank is None:
        from bench import run
        return run.launch_script(Path(__file__).resolve(),
                                 sys.argv[1:], cell.chips)
    rank = args.rank or 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    calibrate(cell, ints(args.seeds), set(ints(args.control)),
              [f for f in args.faults.split(",") if f], device, rank, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
