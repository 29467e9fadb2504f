"""Plain PyTorch versions of the port's kernels (the CPU route of each
wrapper, and what ``chip_smoke.py`` holds each CUDA kernel against)."""
from __future__ import annotations

from typing import Tuple

import torch


def mean_and_sqdev_ref(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: (R, ...) -> (f32 mean over axis 0, Σ_i ||mean − w_i||² f32)."""
    wf = w.reshape(w.shape[0], -1).to(torch.float32)
    mean = wf.mean(dim=0)
    sq = (wf - mean[None]).square().sum()
    return mean.reshape(w.shape[1:]), sq
