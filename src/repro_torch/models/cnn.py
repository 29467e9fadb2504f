"""Small VGG-style CNN for the paper's CIFAR-10-scale experiment (port of
``repro/models/cnn.py``): 3 × 3 convolutions (padding 1) with ReLU and
2 × 2 max pooling, then two dense layers, on 32 × 32 × 3 images.

Layout: the parameters keep the reference's layout — HWIO conv weights,
and ``fc1`` rows in the (h, w, c) order of an NHWC flatten — so the tree
is the reference's leaf for leaf (``interop.params_from_numpy`` copies it
with no permutation) and QSGD, which draws one threefry uniform per
element in each leaf's row-major order and prices one norm per tensor,
quantizes exactly the elements the reference does.  Images arrive NHWC,
as ``SyntheticImages`` makes them.  The computation runs NCHW: the input
is permuted to NCHW at the top of ``cnn_forward`` (a view whose memory is
channels-last), each conv weight to OIHW at its call, and the last
feature map back to NHWC before the flatten.  The convolutions and
pooling are PyTorch's (cuDNN on the card), as the reference leaves them
to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def init_cnn(seed: int, n_classes: int = 10,
             widths: Sequence[int] = (32, 64, 128), *,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Params:
    """Random parameters from ``seed``, drawn as the reference's
    ``init_cnn(jax.random.PRNGKey(seed))`` draws them (``prng.normal``,
    equal to a few f32 ulps): He-normal convolutions and ``fc1``, ``fc2``
    by 1/sqrt(256), zero biases."""
    dev = resolve_device(device)
    keys = prng.split(prng.prng_key(seed), len(widths) + 2)

    def normal(i, *shape):
        return prng.normal(keys[i], shape, device=dev)

    p: Params = {"convs": []}
    c_in = 3
    for i, w in enumerate(widths):
        p["convs"].append({
            "w": (normal(i, 3, 3, c_in, w)
                  * math.sqrt(2.0 / (9 * c_in))).to(dtype),
            "b": torch.zeros(w, dtype=dtype, device=dev),
        })
        c_in = w
    feat = widths[-1] * (32 // (2 ** len(widths))) ** 2
    p["fc1"] = {"w": (normal(-2, feat, 256)
                      * math.sqrt(2.0 / feat)).to(dtype),
                "b": torch.zeros(256, dtype=dtype, device=dev)}
    p["fc2"] = {"w": (normal(-1, 256, n_classes) / math.sqrt(256)).to(dtype),
                "b": torch.zeros(n_classes, dtype=dtype, device=dev)}
    return p


def cnn_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, n_classes)."""
    x = x.permute(0, 3, 1, 2)                         # NHWC -> NCHW view
    for c in p["convs"]:
        w = c["w"].permute(3, 2, 0, 1)                # HWIO -> OIHW
        x = F.max_pool2d(F.relu(F.conv2d(x, w, c["b"], padding=1)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
    x = F.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["fc2"]["w"] + p["fc2"]["b"]


def cnn_loss(p: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict]:
    logits = cnn_forward(p, batch["images"])
    labels = batch["labels"].long()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"ce_loss": loss, "accuracy": acc}
