"""The comparison fails a broken program.  A run of each cell at tiny
size on the CPU (the whole run but the look for a card), with a fault
planted in the timed path, reads ``correct`` false under the cell's own
limits: a step that returns its state unchanged, half of each replica's
batch left out of the loss, the exchange between replicas left out, S_k
reported as 0 (the sqdev half of the sync left out).  The
control, the reference computed in fp8 in the program's place, fails them
too.  (A token altered where it is produced is a fault of served models:
these cells serve none.)"""
import json
import subprocess
import sys
import time

import pytest

from bench import cells, correct, harness, runner
from bench.faults import FAULTS
from bench.reference import train as reference
from bench.tiny import tiny_cell

ALL = [w["name"] for w in cells.load_benchmark()["workloads"]]
ONE = [n for n in ALL if cells.load_cell(n).chips == 1]
MESH = [n for n in ALL if cells.load_cell(n).traffic["backend"] == "mesh"]


def tiny(name):
    return tiny_cell(name, compute_dtype="bfloat16", chips=1)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ONE)
def test_fault_is_not_correct(name, fault):
    cell = tiny(name)
    with FAULTS[fault]():
        result, notes = runner.run(cell, seed=2 ** 31 + 11, seconds=0.0,
                                   trace=False, t_start=time.time(),
                                   device="cpu", strict=False)
    assert result["correct"] is False, notes


@pytest.mark.parametrize("name", ONE)
def test_control_is_not_correct(name):
    cell = tiny(name)
    engine, host, skel, tokens, _ = runner.prepare(cell, 2 ** 31 + 13,
                                                   "cpu", strict=False)
    harness.free_program(engine)
    seed = (2 ** 31 + 13) % harness.ENGINE_SEED_MOD
    ref = reference.follow(cell.config, cell.traffic, skel, host, tokens,
                           seed)
    low = reference.follow(cell.config, cell.traffic, skel, host, tokens,
                           seed, precision="fp8")
    ok, checks = correct.verdict(correct.gaps(low, ref), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", ["", "half_batch", "no_exchange",
                                   "no_sqdev"])
@pytest.mark.parametrize("name", MESH)
def test_mesh_run_on_gloo(name, fault):
    """The multi-card cell's run in 4 CPU processes: sound in f32 it
    agrees with the reference; each fault is not correct under the
    cell's limits."""
    cell = cells.load_cell(name)
    out = subprocess.run(
        [sys.executable, str(cells.BENCH_DIR / "tiny_mesh.py"),
         "--workload", name, "--world", str(cell.chips)]
        + (["--fault", fault] if fault else ["--limit", "1e-4"]),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is (not fault), out.stderr[-2000:]
    assert result["device"]["count"] == cell.chips
