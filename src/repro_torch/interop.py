"""Moving parameter trees between the JAX reference and the port.

The reference's parameters (or a replica-stacked W, or an adamw state) are
nested dicts/lists of arrays with the same layout as the port's, so the
move is a copy with no transposes.  The reference side hands over numpy
arrays (``np.asarray`` of a jax array works as is).  Containers keep their
shape, empty dicts included: OLMo's non-parametric norms are ``{}`` and a
block without its ``norm1`` key would read as a different model.  The
CNN (``models/cnn.py``) keeps the reference's HWIO convolutions and NHWC
``fc1`` row order for the same reason QSGD needs it, so its parameters
cross unpermuted too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists/tuples of arrays -> the same structure of tensors
    on ``device`` (the card unless ``"cpu"`` is passed).  Tuples become
    lists, as the port's trees use lists."""
    device = resolve_device(device)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [go(v) for v in x]
        return torch.from_numpy(np.array(x)).to(device)

    return go(tree)


def params_to_numpy(tree: Any) -> Any:
    """The port's tensors -> the same structure of numpy arrays on the
    host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
