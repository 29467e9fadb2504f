"""The inputs of a run, made from ``--seed`` on the run's device: the
initial weights (one tree, handed to the program as its ``params0`` and
to the reference) and the token batches.

The tree has the program's layout (nested dicts, a list of blocks, each
dense weight ``(d_in, d_out)`` under ``"w"``), written out from the
configuration file's sizes by its family's module
(``bench/archs/<model_type>.py``: ``param_specs`` and ``empty_tree``).
All weights come from one ``torch.Generator`` on the device: one normal
draw of every parameter at once into a flat f32 buffer, cut into the
leaves and scaled leaf by leaf.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.archs import arch_of

SEED_MIX = 0x9E3779B97F4A7C15       # keeps the weights' and data's streams apart


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        if isinstance(node, dict) and p not in node:
            node[p] = {}
        node = node[p]
    node[path[-1]] = value


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * SEED_MIX + stream) % (1 << 63))
    return g


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The initial weights, f32, from ``seed``: one normal draw of all
    drawn leaves, then each leaf's slice scaled; norm scales are ones.
    Each leaf is a view of the one buffer."""
    arch = arch_of(cfg)
    specs = arch.param_specs(cfg)
    n = sum(math.prod(s) for _, s, sc in specs if sc)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(generator=generator(seed, 1, device))
    tree = arch.empty_tree(cfg)
    at = 0
    for path, shape, scale in specs:
        if scale:
            k = math.prod(shape)
            leaf = flat[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        _put(tree, path, leaf)
    return tree


def make_tokens(vocab: int, steps: int, replicas: int, batch: int, seq: int,
                seed: int, device) -> torch.Tensor:
    """(steps, R, b, S) int32 token ids, uniform over the vocabulary: the
    batches of ``steps`` iterations, cycled by ``batch_of``."""
    return torch.randint(0, vocab, (steps, replicas, batch, seq),
                         generator=generator(seed, 2, device), device=device,
                         dtype=torch.int32)


def batch_of(tokens: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Iteration k's batch: (R, b, S) tokens."""
    return {"tokens": tokens[k % tokens.shape[0]]}
