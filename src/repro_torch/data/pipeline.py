"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

The arrays come from ``numpy.random.RandomState`` exactly as in the
reference, so batches are bit-identical; only the last step differs — each
batch is handed over as torch tensors on the requested device.  A fixed
dataset, globally shuffled each epoch, then sharded across replicas (paper
§IV-A).  ``SyntheticImages`` hands over NHWC images, as the reference
does; ``models/cnn.py`` permutes them to NCHW inside the forward pass.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class SyntheticImages:
    """CIFAR-10-shaped classification data: class prototypes + noise.
    Stands in for the paper's CIFAR-10 experiments."""

    def __init__(self, n_samples: int = 4096, n_classes: int = 10,
                 noise: float = 0.6, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.protos = rng.randn(n_classes, 32, 32, 3).astype(np.float32)
        self.labels = rng.randint(0, n_classes, size=n_samples).astype(np.int32)
        self.images = (self.protos[self.labels]
                       + noise * rng.randn(n_samples, 32, 32, 3)).astype(np.float32)
        self.n = n_samples
        self.seed = seed

    def batches(self, *, n_replicas: int, per_replica_batch: int,
                device: DeviceLike = None) -> "EpochSharder":
        return EpochSharder({"images": self.images, "labels": self.labels},
                            self.n, n_replicas, per_replica_batch, self.seed,
                            device=device)

    def eval_batches(self, batch: int = 256, device: DeviceLike = None):
        device = resolve_device(device)
        for i in range(0, self.n, batch):
            yield {"images": torch.from_numpy(
                       self.images[i:i + batch]).to(device),
                   "labels": torch.from_numpy(
                       self.labels[i:i + batch]).to(device)}


class SyntheticTokens:
    """LM data from a learnable stochastic process: token_{t+1} =
    (a·token_t + c) mod V with probability 1−ε, uniform otherwise."""

    def __init__(self, vocab_size: int, seq_len: int, n_samples: int = 2048,
                 eps: float = 0.1, seed: int = 0):
        rng = np.random.RandomState(seed + 1)
        a, c = 31, 17
        toks = np.zeros((n_samples, seq_len), np.int32)
        toks[:, 0] = rng.randint(0, vocab_size, n_samples)
        for t in range(1, seq_len):
            det = (a * toks[:, t - 1] + c) % vocab_size
            rand = rng.randint(0, vocab_size, n_samples)
            toks[:, t] = np.where(rng.rand(n_samples) < eps, rand, det)
        self.tokens = toks
        self.n = n_samples
        self.seed = seed

    def batches(self, *, n_replicas: int, per_replica_batch: int,
                device: DeviceLike = None) -> "EpochSharder":
        return EpochSharder({"tokens": self.tokens}, self.n, n_replicas,
                            per_replica_batch, self.seed, device=device)

    def eval_batches(self, batch: int = 64, limit: int = 512,
                     device: DeviceLike = None):
        device = resolve_device(device)
        for i in range(0, min(self.n, limit), batch):
            yield {"tokens": torch.from_numpy(
                self.tokens[i:i + batch]).to(device)}


class EpochSharder:
    """step -> batch dict with a leading replica axis (R, b, ...).  Each
    epoch reshuffles globally with a deterministic per-epoch seed."""

    def __init__(self, arrays: Dict[str, np.ndarray], n: int,
                 n_replicas: int, per_replica_batch: int, seed: int, *,
                 device: DeviceLike = None):
        self.arrays = arrays
        self.n = n
        self.R = n_replicas
        self.b = per_replica_batch
        self.global_b = n_replicas * per_replica_batch
        self.steps_per_epoch = max(1, n // self.global_b)
        self.seed = seed
        self.device = resolve_device(device)
        self._epoch = -1
        self._perm: Optional[np.ndarray] = None

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        epoch, within = divmod(step, self.steps_per_epoch)
        if epoch != self._epoch:
            self._perm = np.random.RandomState(
                self.seed + 1000 + epoch).permutation(self.n)
            self._epoch = epoch
        idx = self._perm[within * self.global_b:(within + 1) * self.global_b]
        return {k: torch.from_numpy(
                    v[idx].reshape(self.R, self.b, *v.shape[1:])).to(self.device)
                for k, v in self.arrays.items()}
