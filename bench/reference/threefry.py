"""Threefry-2x32 (Salmon et al. 2011, 20 rounds) and the key functions
built on it, in jax.random's partitionable form: the stream the program's
QSGD uniforms come from (``repro_torch/core/prng.py``), frozen here so
that the reference draws the same uniforms from the same seed.

A key is a pair of ints; ``fold_in(key, d)`` hashes the counter (0, d),
``split(key, n)`` the counters (0, i); element i of ``uniform(key,
shape)`` hashes (i >> 32, i & 0xFFFFFFFF), its bits are x0 ^ x1 and the
float is ``bitcast((bits >> 9) | 0x3F800000) - 1``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]
MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def threefry2x32(key: Key, x0, x1):
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> Key:
    return (0, seed & MASK)


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k, 0, data & MASK)


def split(k: Key, n: int) -> List[Key]:
    return [threefry2x32(k, 0, i) for i in range(n)]


def uniform(k: Key, shape: Sequence[int], device) -> torch.Tensor:
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    step = 1 << 24
    for a in range(0, n, step):
        idx = torch.arange(a, min(n, a + step), dtype=torch.int64,
                           device=device)
        b0, b1 = threefry2x32(k, idx >> 32, idx & MASK)
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        out[a:a + len(idx)] = bits.to(torch.int32).view(torch.float32) - 1.0
    return out.view(tuple(shape))
