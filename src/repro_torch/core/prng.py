"""The reference's random key stream, without JAX.

The reference draws QSGD's stochastic-rounding uniforms from
``jax.random`` with the threefry2x32 generator in its partitionable form
(the default of the JAX release the reference runs).  Matching it bit for
bit keeps the port's quantized exchanges on the reference's trajectory, so
this module reproduces the four functions the reference uses:

* ``prng_key(seed)``   — ``jax.random.PRNGKey(seed)``: the pair (0, seed);
* ``fold_in(key, d)``  — threefry(key, (0, d));
* ``split(key, n)``    — [threefry(key, (0, i)) for i < n];
* ``uniform(key, shape)`` — f32 in [0, 1): element i (row-major) hashes the
  counter pair (i >> 32, i & 0xFFFFFFFF); its 32 bits are x0 ^ x1, and the
  float is ``bitcast((bits >> 9) | 0x3F800000) − 1``.

and ``normal(key, shape)`` — ``jax.random.normal``, for the CNN's initial
parameters: uniforms on (−1, 1) bit for bit, then XLA's single-precision
``erf_inv``.  Its ``log1p`` rounds differently from XLA's, so a few
per cent of the values differ from jax's by up to three f32 ulps
(relative 2.4e-7 at most in the tests).

A key is a pair of Python ints, worked on the host.  Only the per-element
bits of ``uniform`` are computed on the device, in int64 tensors masked to
32 bits (torch's uint32 has no shifts or xor on CUDA); ``normal`` computes
them a chunk of the counter range at a time.  The QSGD quantize kernel
computes the same bits in 32-bit registers from the key
(``csrc/qsgd_quant.cu``).  Chunking is exact: element
i's counter is (i >> 32, i & 0xFFFFFFFF) wherever the chunk starts.  ``threefry2x32``
is written with plain operators, so the same code hashes Python ints and
tensors.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# elements per chunk of a draw: each int64 transient of a chunk is 32 MB,
# smaller than the large weights drawn between chunks, so the CUDA caching
# allocator never carves a weight out of a freed transient's block (with
# 2^26, 512 MB transients, drawing Qwen2.5-14B's 59 GB on an 80 GB card
# left 23 GiB reserved in fragments and failed)
CHUNK = 1 << 22


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) of the counter
    pair (x0, x1) under ``key``.  x0 and x1 are ints in [0, 2^32) or int64
    tensors holding such values; returns the hashed pair in the same
    form."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return (0, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, 0, data & MASK)


def split(key: Key, n: int) -> List[Key]:
    return [threefry2x32(key, 0, i) for i in range(n)]


def replica_keys(key: Key, idx: Sequence[int]) -> List[Key]:
    """Per-replica keys: ``fold_in`` on the global replica index, the one
    derivation every backend shares."""
    return [fold_in(key, int(i)) for i in idx]


def _uniform_range(key: Key, start: int, stop: int, device) -> torch.Tensor:
    """The flat uniforms of elements [start, stop) of a draw under
    ``key``: each element's counter is its own index, so any range of the
    draw is computed alone."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK)
    del idx
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    del b0, b1
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _draw(key: Key, shape: Sequence[int], device, fn) -> torch.Tensor:
    """``fn`` of the uniforms of ``shape``, computed ``CHUNK`` elements at
    a time into one f32 buffer, so the int64 counters and words of a
    large draw (about 44 bytes of transients per element) never exist
    for more than one chunk.  A draw of one chunk is returned as computed;
    one on the meta device (shapes without storage) is an f32 tensor of
    the shape, with no threefry round traced."""
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    if n <= CHUNK:
        return fn(_uniform_range(key, 0, n, device)).reshape(tuple(shape))
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[start:stop] = fn(_uniform_range(key, start, stop, device))
    return out.reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` on ``device``, bit-identical to
    ``jax.random.uniform(key, shape)``, drawn in one piece (the transients
    are about 44 bytes per element).  QSGD's plain route draws these; its
    kernel route draws the same bits inside the quantize kernel
    (``kernels/qsgd_quant.py::quantize_keyed``)."""
    n = math.prod(shape)
    return _uniform_range(key, 0, n, device).reshape(tuple(shape))


# XLA's single-precision erf_inv, the one jax.random.normal uses: M.
# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# a degree-8 polynomial in w = -log1p(-x^2), shifted by 2.5 below w = 5
# and in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return p * x


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """f32 standard normals of ``shape`` on ``device``, as
    ``jax.random.normal(key, shape)`` draws them: sqrt(2)·erf_inv(u) with
    u uniform on [lo, 1), lo the f32 just above −1, scaled from
    ``uniform(key, shape)`` as jax scales it (the span 1 − lo rounds to 2
    in f32).  Drawn ``CHUNK`` elements at a time: the initial parameters
    of a large model are drawn while most of them are already resident."""
    lo = -1.0 + 2.0 ** -24
    return _draw(key, shape, device, lambda u: _erfinv(
        torch.clamp_min(u * 2.0 + lo, lo)) * math.sqrt(2.0))
