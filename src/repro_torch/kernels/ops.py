"""Public wrappers for the port's kernels: the model and the sync call
these, never a kernel module directly.  Each wrapper launches its CUDA
kernel for a CUDA tensor and uses the plain version for a CPU tensor."""
from __future__ import annotations

from repro_torch.kernels import param_variance as _pv


def param_mean_and_sqdev(w):
    return _pv.mean_and_sqdev(w)
