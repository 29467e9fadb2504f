"""The reference against the port at a tiny size on the CPU, through the
harness's whole run (set-up, window, comparison): both models, and the
three kinds of sync — the vmap mean, the mesh's mean over ranks (one gloo
rank) and qsgd_periodic's quantized exchange.  In f32 the two agree to
rounding; in bf16, as the cells run, to bf16's rounding."""
import dataclasses
import time

import pytest
import torch

from bench import correct, runner
from bench.tiny import tiny_cell

F32_LIMIT = 1e-4         # f32 against f32: a few ulps through adam's steps
CASES = [
    ("olmo1b-adpsgd-1gpu", None, None),
    ("dsv2lite-adpsgd-1gpu", None, None),
    ("olmo1b-adpsgd-1gpu", "qsgdp8-vmap-r2-b2-s2048", None),
    ("dsv2lite-adpsgd-1gpu", "qsgdp8-vmap-r2-b2-s2048", None),
    ("olmo1b-adpsgd-1gpu", "adpsgd-mesh4-b2-s2048", None),
]


def run_tiny(cell, seed=2 ** 31 + 7):
    torch.manual_seed(0)
    return runner.run(cell, seed=seed, seconds=0.0, trace=False,
                      t_start=time.time(), device="cpu", strict=False)


@pytest.mark.parametrize("name,traffic,config", CASES,
                         ids=[f"{n}-{t or 'own'}" for n, t, _ in CASES])
def test_reference_matches_port(name, traffic, config):
    cell = tiny_cell(name, traffic, config, chips=1)
    if cell.traffic["backend"] == "mesh":
        cell.traffic = dict(cell.traffic, replicas=2)
    cell = dataclasses.replace(cell, limits={
        "limits": dict.fromkeys(correct.NAMES, F32_LIMIT)})
    result, notes = run_tiny(cell)
    assert result["correct"], notes
    assert result["attempted"] >= 2
    assert set(result["metrics"]) >= {"train_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_bf16_gaps_are_bf16_sized():
    """With the cells' bf16 compute the gaps are those of bf16 rounding:
    above f32's, and far under the control's and the faults'."""
    cell = tiny_cell("olmo1b-adpsgd-1gpu", compute_dtype="bfloat16")
    cell = dataclasses.replace(cell, limits={
        "limits": dict.fromkeys(correct.NAMES, 0.1)})
    result, notes = run_tiny(cell)
    assert result["correct"], notes
    gaps = [c["value"] for c in result["checks"].values()]
    assert max(gaps) > 1e-5
